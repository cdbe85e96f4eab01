"""Build and load the port's hand-written CUDA kernels.

Each ``genomics_lm_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
that ``ctypes`` loads — no PyTorch headers, so a build takes seconds, not
the minutes of ``torch.utils.cpp_extension``. A source may include the
shared headers ``csrc/*.cuh``. A library is built at first use and again
whenever its source, a header or the flags change: the file name carries a
hash of all three. Builds land in ``genomics_lm_torch/kernels/_build``
(git-ignored); the ``nvcc -Xptxas -v`` report (registers, shared memory,
spills) is kept beside each library as ``<lib>.log``.

``build_host`` builds a host C++ library (``native/genomics_native.cpp``)
the same way: ``g++`` (or ``$CXX``) with ``GXX_FLAGS``, the hash of source
and flags in the file name, an atomic ``os.replace``, the compiler's output
in ``<lib>.log``; a failed build raises with that output, a missing
compiler raises and names it.

Nothing is built or loaded at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --split-compile=0 runs each source's device-code optimization on every
# core: the four builds start together, and decode_attention.cu's 48
# template instances took 153.9 s alone against 77.4 s so (same registers
# and spills; one H100 machine, nvcc 12.8)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--split-compile=0",
)
_BUILD_TIMEOUT_S = 600
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit default."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives for its current
    source and headers."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, Path]:
    """Build every named kernel library that is missing, all nvcc runs at once.

    Returns {name: library path}. Raises with nvcc's output if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out\n{log}")
            continue
        lib = todo[name]
        lib.with_name(f"{lib.name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def gxx_path() -> str:
    """``$CXX`` if set, else ``g++``, resolved on PATH."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if not found:
        raise RuntimeError(f"{name} not found: the host library needs a C++17 compiler "
                           "(put g++ on PATH or set CXX)")
    return found


def host_library_path(source: Path) -> Path:
    """Where the host library built from ``source`` lives for its current text."""
    digest = hashlib.sha256(source.read_bytes() + "\0".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_host(source: Path) -> Path:
    """Build the host C++ library of ``source`` if it is missing; its path.

    Raises with the compiler's output if the build fails.
    """
    lib = host_library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = gxx_path()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp), str(source)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=_BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of {source.name}: {cxx} timed out\n{exc.output}") from exc
    lib.with_name(f"{lib.name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"host build of {source.name} failed: {cxx} exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))


__all__ = ["BUILD_DIR", "CSRC", "GXX_FLAGS", "NVCC_FLAGS", "build", "build_host", "gxx_path",
           "host_library_path", "library_path", "load", "nvcc_path"]
