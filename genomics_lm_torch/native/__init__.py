"""ctypes bindings for the native C++ data-path library (the port's own copy
of ``genomics_lm_tpu/native/__init__.py``, the same entry points).

``genomics_native.cpp`` beside this file is built at first use with ``g++
-O3 -fPIC -shared -std=c++17`` by ``kernels/build.py::build_host`` into the
git-ignored ``kernels/_build/`` (the file name carries a hash of the source
and flags). There is no silent fallback: a failed build raises with the
compiler's output, a missing compiler raises and names it, and every entry
point then raises too; ``available()`` reports without raising.

Beside each entry point stands its plain version (``*_reference``), which
the tests hold the library to and nothing else calls. The plain
``minhash_cluster_reference`` reproduces the library's ESTIMATE of the
shingle Jaccard bit for bit (FNV-1a over each shingle, the splitmix64
finalizer of ``base ^ j * 0xc2b2ae3d27d4eb4f``, greedy agreement >=
``min_jaccard``), not the exact Jaccard of the JAX package's pure-Python
fallback, so clusters never depend on whether a compiler was found.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

import numpy as np

from genomics_lm_torch.kernels import build as build_lib

SOURCE = Path(__file__).resolve().parent / "genomics_native.cpp"


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    lib = ctypes.CDLL(str(build_lib.build_host(SOURCE)))
    lib.tokenize_codons.restype = ctypes.c_int
    lib.tokenize_codons.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.reverse_complement.restype = None
    lib.reverse_complement.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char),
    ]
    lib.sha256.restype = None
    lib.sha256.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.minhash_signatures.restype = None
    lib.minhash_signatures.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.minhash_greedy_cluster.restype = ctypes.c_int
    lib.minhash_greedy_cluster.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def available() -> bool:
    """Whether the library builds and loads (never raises)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def library_path() -> Path:
    """The file the library is (or would be) loaded from."""
    return build_lib.host_library_path(SOURCE)


def _ascii(text: str) -> bytes:
    return text.encode("ascii", errors="replace")


def tokenize_codons(dna: str) -> np.ndarray:
    """DNA → per-codon ids (int32; ``U`` reads as ``T``, -1 for a codon with
    any other base)."""
    lib = _load()
    data = _ascii(dna)
    out = np.empty(len(data) // 3, dtype=np.int32)
    lib.tokenize_codons(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def reverse_complement(seq: str) -> str:
    """Reverse complement of ACGT/acgt; any other byte passes through."""
    lib = _load()
    data = _ascii(seq)
    out = ctypes.create_string_buffer(len(data))
    lib.reverse_complement(data, len(data), out)
    return out.raw.decode("ascii")


def sha256_hex(data: bytes) -> str:
    lib = _load()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else (ctypes.c_uint8 * 1)()
    out = (ctypes.c_uint8 * 32)()
    lib.sha256(buf, len(data), out)
    return bytes(out).hex()


def minhash_cluster(
    sequences: list[str], *, k: int = 5, n_hashes: int = 64, min_jaccard: float = 0.5
) -> np.ndarray:
    """Greedy minhash clustering; returns representative index per sequence."""
    n = len(sequences)
    if n == 0:
        return np.zeros(0, np.int32)
    lib = _load()
    concat = _ascii("".join(sequences))
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in sequences], out=offsets[1:])
    sigs = np.empty(n * n_hashes, dtype=np.uint64)
    lib.minhash_signatures(
        concat, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, k, n_hashes,
        sigs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    labels = np.empty(n, dtype=np.int32)
    lib.minhash_greedy_cluster(
        sigs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, n_hashes,
        float(min_jaccard), labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return labels


def native_protein_clusters(
    proteins: dict[str, str], *, min_identity: float = 0.3,
    k: int = 4, n_hashes: int = 64,
) -> dict[str, list[str]]:
    """MMseqs2-easy-cluster-shaped output from minhash greedy clustering.

    ``min_identity`` maps to a shingle-jaccard threshold via the standard
    approximation j ≈ t / (2 − t) for identity t — conservative (clusters
    more aggressively than alignment identity would), which is the right
    failure direction for leakage screening.
    """
    ids = list(proteins.keys())
    seqs = [proteins[i] for i in ids]
    t = float(min_identity)
    jaccard = max(0.05, t / (2.0 - t))
    labels = minhash_cluster(seqs, k=k, n_hashes=n_hashes, min_jaccard=jaccard)
    clusters: dict[str, list[str]] = {}
    for i, label in enumerate(labels):
        clusters.setdefault(ids[int(label)], []).append(ids[i])
    return clusters


# --- plain versions (the tests' reference; nothing else calls them) ----------

_BASE_CODE = np.full(256, -1, dtype=np.int32)
for _code, _bases in enumerate((b"Aa", b"Cc", b"Gg", b"TtUu")):
    for _b in _bases:
        _BASE_CODE[_b] = _code
_COMPLEMENT = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
_FNV_OFFSET = np.uint64(1469598103934665603)
_FNV_PRIME = np.uint64(1099511628211)
_SEED_STEP = np.uint64(0xC2B2AE3D27D4EB4F)


def tokenize_codons_reference(dna: str) -> np.ndarray:
    raw = np.frombuffer(_ascii(dna), dtype=np.uint8)
    n = len(raw) // 3
    b = _BASE_CODE[raw[: 3 * n]].reshape(n, 3)
    ids = 4 + b[:, 0] * 16 + b[:, 1] * 4 + b[:, 2]
    return np.where((b < 0).any(axis=1), -1, ids).astype(np.int32)


def reverse_complement_reference(seq: str) -> str:
    return _ascii(seq).translate(_COMPLEMENT)[::-1].decode("ascii")


def sha256_hex_reference(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _mix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer on uint64 (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _signatures_reference(sequences: list[str], k: int, n_hashes: int) -> np.ndarray:
    """(n, n_hashes) uint64 minhash signatures, as ``minhash_signatures``."""
    sigs = np.full((len(sequences), n_hashes), np.iinfo(np.uint64).max, dtype=np.uint64)
    seeds = np.arange(n_hashes, dtype=np.uint64) * _SEED_STEP
    with np.errstate(over="ignore"):
        for s, seq in enumerate(sequences):
            raw = np.frombuffer(_ascii(seq), dtype=np.uint8).astype(np.uint64)
            n_shingles = len(raw) - k + 1
            if n_shingles <= 0:
                continue
            base = np.full(n_shingles, _FNV_OFFSET, dtype=np.uint64)
            for i in range(k):  # FNV-1a over each shingle
                base = (base ^ raw[i : i + n_shingles]) * _FNV_PRIME
            sigs[s] = _mix64(base[:, None] ^ seeds[None, :]).min(axis=0)
    return sigs


def minhash_cluster_reference(
    sequences: list[str], *, k: int = 5, n_hashes: int = 64, min_jaccard: float = 0.5
) -> np.ndarray:
    sigs = _signatures_reference(sequences, k, n_hashes)
    labels = np.empty(len(sequences), dtype=np.int32)
    reps: list[int] = []
    for s in range(len(sequences)):
        assigned = s
        if reps:
            agree = (sigs[reps] == sigs[s]).sum(axis=1) / n_hashes >= float(min_jaccard)
            if agree.any():
                assigned = reps[int(np.argmax(agree))]
        if assigned == s:
            reps.append(s)
        labels[s] = assigned
    return labels


__all__ = [
    "available",
    "library_path",
    "minhash_cluster",
    "minhash_cluster_reference",
    "native_protein_clusters",
    "reverse_complement",
    "reverse_complement_reference",
    "sha256_hex",
    "sha256_hex_reference",
    "tokenize_codons",
    "tokenize_codons_reference",
]
