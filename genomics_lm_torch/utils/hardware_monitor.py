"""Heartbeat monitor: host memory, the card's memory and a run's
``curves.csv`` growth (twin of ``scripts/hardware_monitor.py``, the same
flags).

    python -m genomics_lm_torch.utils.hardware_monitor [--run_dir RUN] \\
        [--interval 30] [--iterations 0] [--device]

Each line reads ``/proc/meminfo``'s available and total bytes; with
``--run_dir`` the number of lines in ``<run>/scores/curves.csv``; with
``--device`` the bytes PyTorch's allocator holds on the CUDA card
(``training/runtime.py::device_memory_stats``). Without a card
``--device`` raises, where JAX on its CPU backend leaves ``hbm=`` out.
``--iterations 0`` polls until stopped.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def meminfo() -> dict:
    out = {}
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            key, _, rest = line.partition(":")
            if key in {"MemTotal", "MemAvailable"}:
                out[key] = int(rest.split()[0]) * 1024
    except OSError:
        pass
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run_dir", default=None, help="watch this run's curves.csv")
    ap.add_argument("--interval", type=float, default=30.0)
    ap.add_argument("--iterations", type=int, default=0, help="0 = forever")
    ap.add_argument("--device", action="store_true",
                    help="also poll the CUDA card's memory (raises without a card)")
    args = ap.parse_args(argv)

    curves = Path(args.run_dir) / "scores" / "curves.csv" if args.run_dir else None
    i = 0
    while True:
        info = meminfo()
        line = (
            f"[monitor] mem_available={info.get('MemAvailable', 0) / 1e9:.2f}GB"
            f"/{info.get('MemTotal', 0) / 1e9:.2f}GB"
        )
        if args.device:
            from genomics_lm_torch.training.runtime import device_memory_stats

            stats = device_memory_stats()
            line += f" hbm={stats['bytes_in_use'] / 1e9:.2f}GB"
        if curves and curves.exists():
            rows = curves.read_text().count("\n")
            line += f" curve_rows={rows}"
        print(line, flush=True)
        i += 1
        if args.iterations and i >= args.iterations:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
