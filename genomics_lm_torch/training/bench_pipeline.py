"""``bench.py``'s three training protocols on the card (twin of ``bench.py:94-305``).

One built model and group step (``training/profile_step.py``: the 10L8H
d384 CodonGPT, bf16, flash attention, dropout 0.1, AdamW; G 16 x B 8 x
T 512) run three protocols in turn:

- ``synthetic``: full windows already on the device (``bench.py:94-141``);
- ``real_pipeline("multi")`` and ``real_pipeline("binpack")``
  (``bench.py:184-257``): a packed dataset built through the real chunking
  and packing (``build_packed_dataset``: the same seed and lognormal record
  lengths as ``bench.py:143-181``) with ``.npy`` mmap sidecars, read through
  ``EpochPlan`` and ``grouped_batches`` (full groups only), staged on the
  card by ``DevicePrefetcher`` from pinned memory every step.

Each protocol takes ``WARMUP_STEPS`` groups, then times ``MEASURE_STEPS``
groups between two synchronisations (non-pad target tokens counted on the
host per second), then runs a few more groups under ``torch.profiler`` for
the device's busy share and the host→device copies in the trace. Each
group's non-pad tokens are also counted on the device by the step, and the
two counts must agree. It prints one JSON line with the keys of
``bench.py``'s default run (``value`` is the binpack number,
``reference_packing_protocol`` the multi one, ``synthetic_device_only`` the
synthetic one), plus pad fractions, ms per group, busy shares and the
flash kernels' device time. ``--repeats N`` runs the three N times in
alternating order and reports each one's median run beside every run's
tokens/s: the host sets these times, and they drift between runs. Needs a
CUDA card:

    python -m genomics_lm_torch.training.bench_pipeline [--repeats 3]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.data.datasets import (
    DevicePrefetcher,
    EpochPlan,
    PackedDataset,
    grouped_batches,
)
from genomics_lm_torch.data.packing import chunk_record, pack_chunks, packed_arrays
from genomics_lm_torch.training import profile_step as main_path

BASELINE_TOKENS_PER_SEC = 2891.9  # bench.py:41, the reference runtime gate
WARMUP_STEPS = 3
MEASURE_STEPS = 20
PROFILE_GROUPS = 3


def build_packed_dataset(n_windows: int, block_size: int, out_dir: Path,
                         pack_mode: str = "multi"):
    """``bench.py``'s packed dataset through the port's chunk → pack → arrays
    copy: records of lognormal length around ~250 codons (seed 1337) until
    they fill ``n_windows`` windows with 10% to spare, packed with ``<SEP>``
    (3), written as ``bench_train.npz`` with ``_X/_Y.npy`` mmap sidecars.
    Returns (npz path, pad fraction of the targets)."""
    rng = np.random.default_rng(1337)
    records = []
    line = 0
    while True:
        n_codons = int(np.clip(rng.lognormal(5.4, 0.6), 30, 1600))
        tokens = [1] + list(rng.integers(4, 68, n_codons)) + [2]
        records.append({
            "tokens": tokens,
            "source_id": f"synth:{line}",
            "source_line_idx": line,
            "fragment_line_idx": line,
            "fragment_index": 0,
            "split": "train",
            "fragment_codon_start": 0,
            "fragment_codon_end": n_codons,
        })
        line += 1
        if line % 64 == 0:
            total = sum(len(r["tokens"]) for r in records)
            if total > n_windows * (block_size + 1) * 1.1:
                break
    chunks = [c for r in records for c in chunk_record(r, block_size)]
    windows = pack_chunks(chunks, block_size=block_size, mode=pack_mode, sep_id=3)
    arrays = packed_arrays(windows, block_size=block_size, mode="fixed")
    out_dir.mkdir(parents=True, exist_ok=True)
    npz = out_dir / "bench_train.npz"
    np.savez(npz, X=arrays["X"], Y=arrays["Y"])
    np.save(out_dir / "bench_train_X.npy", arrays["X"])
    np.save(out_dir / "bench_train_Y.npy", arrays["Y"])
    pad_fraction = float(np.mean(arrays["Y"] == 0))
    return npz, pad_fraction


def _drive(built, gen, next_group, n: int):
    """Take ``n`` group steps on the groups ``next_group()`` gives ((x, y) on
    the card, host non-pad count), between two synchronisations: (seconds,
    seconds spent waiting in ``next_group``, host counts, the step's device
    counts as one host list)."""
    _, model, bundle, step = built
    host, device = [], []
    fetch_s = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        t_fetch = time.perf_counter()
        dx, dy, nonpad = next_group()
        fetch_s += time.perf_counter() - t_fetch
        metrics = step(model, bundle, {"x": dx.long(), "y": dy.long()}, gen, 1.0)
        host.append(nonpad)
        device.append(metrics["nonpad_tokens"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, fetch_s, host, torch.stack(device).cpu().tolist()


def _protocol(built, gen, next_group, measure: int = MEASURE_STEPS,
              profile_groups: int = PROFILE_GROUPS) -> dict:
    """Warm-up, measured and profiled groups of one protocol."""
    warmup = WARMUP_STEPS
    _drive(built, gen, next_group, warmup)
    seconds, fetch_s, host, device = _drive(built, gen, next_group, measure)
    # the card's activity only: every number below reads kernels and copies,
    # and the host ops' events took most of the trace's processing time
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_s, _, p_host, p_device = _drive(built, gen, next_group, profile_groups)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and main_path._device_us(e) > 0]
    device_us = sum(main_path._device_us(e) for e in events)
    copies = [e for e in events if "Memcpy HtoD" in e.key]
    flash = [e for e in events if "flash_" in e.key]
    ms = seconds * 1e3 / measure
    device_ms = device_us / 1e3 / profile_groups
    return {
        "value": sum(host) / seconds,
        "groups": measure,
        "nonpad_tokens_per_group": sum(host) / measure,
        "ms_per_group": ms,
        # the consumer's wait for its next group: the prefetcher's lag
        "fetch_ms_per_group": fetch_s * 1e3 / measure,
        "device_ms_per_group": device_ms,
        # the profiler slows the host, not the device: the unprofiled
        # groups' busy share divides the same device time by their wall time
        "device_busy_share": device_ms / ms,
        "device_busy_share_profiled": device_us / 1e6 / prof_s,
        "h2d_copies_per_group": sum(e.count for e in copies) / profile_groups,
        "h2d_copy_ms_per_group": sum(main_path._device_us(e) for e in copies)
        / 1e3 / profile_groups,
        "flash_ms_per_group": sum(main_path._device_us(e) for e in flash)
        / 1e3 / profile_groups,
        "kernel_launches_per_group": sum(e.count for e in events) / profile_groups,
        "device_nonpad_equals_host": (host == device and p_host == p_device),
        "groups_run": warmup + measure + profile_groups,
    }


def run_synthetic(built, gen, **depth) -> dict:
    """Full synthetic windows staged on the card once (``bench.py:94-141``).
    ``depth`` (``measure``, ``profile_groups``) overrides the group counts."""
    batches = [main_path.make_batch(s, "cuda") for s in range(main_path.BATCHES)]
    counts = [int((b["y"] != 0).sum()) for b in batches]
    turn = iter(range(1 << 30))

    def next_group():
        i = next(turn) % len(batches)
        return batches[i]["x"], batches[i]["y"], counts[i]

    out = _protocol(built, gen, next_group, **depth)
    out["protocol"] = "synthetic_device_only"
    return out


def run_real_pipeline(built, gen, pack_mode: str = "multi", *,
                      measure: int = MEASURE_STEPS,
                      profile_groups: int = PROFILE_GROUPS) -> dict:
    """The real host pipeline (``bench.py:184-257``): packing, mmap sidecars,
    ``EpochPlan`` shards, grouped microbatches and a prefetched copy from
    pinned memory every step."""
    cfg = built[0]
    G, B = main_path.G, main_path.B
    n_groups = WARMUP_STEPS + measure + profile_groups
    with tempfile.TemporaryDirectory(prefix="bench_realpipe_") as tmp:
        t0 = time.perf_counter()
        npz, pad_fraction = build_packed_dataset(
            n_windows=(n_groups + 2) * G * B, block_size=cfg.block_size,
            out_dir=Path(tmp), pack_mode=pack_mode)
        build_s = time.perf_counter() - t0
        ds = PackedDataset(npz, use_mmap=True)

        def put_group(item):
            gx, gy, _ = item
            return gx, gy, int(np.sum(gy != 0))

        def epoch_groups(epoch: int):
            plan = EpochPlan(ds, batch_size=B, seed=main_path.SEED, epoch=epoch)
            full = (g for g in grouped_batches(plan, G) if g[0].shape[0] == G)
            return DevicePrefetcher(full, put_group, depth=2, device="cuda")

        state = {"epoch": 1, "groups": epoch_groups(1)}

        def next_group():
            while True:
                try:
                    return next(state["groups"])
                except StopIteration:
                    state["groups"].close()
                    state["epoch"] += 1
                    state["groups"] = epoch_groups(state["epoch"])

        try:
            out = _protocol(built, gen, next_group, measure, profile_groups)
        finally:
            state["groups"].close()
    out.update(protocol=f"real_pipeline({pack_mode})", pack_mode=pack_mode,
               pad_fraction=pad_fraction, windows=len(ds), dataset_build_s=build_s,
               storage=ds.storage_mode)
    return out


def summarize(synthetic: dict, multi: dict, binpack: dict) -> dict:
    """The three protocols' results as ``bench.py``'s one line (its keys)."""
    def vs(row):
        return row["value"] / BASELINE_TOKENS_PER_SEC

    return {
        "metric": "train_nonpad_codon_tokens_per_sec_per_chip",
        "value": binpack["value"],
        "unit": "tokens/sec",
        "vs_baseline": vs(binpack),
        "protocol": f"real_pipeline(binpack, pad={binpack['pad_fraction']:.4f})",
        "pad_fraction": binpack["pad_fraction"],
        "reference_packing_protocol": dict(
            multi, vs_baseline=vs(multi),
            protocol=f"real_pipeline(multi, pad={multi['pad_fraction']:.4f})"),
        "synthetic_device_only": dict(synthetic, vs_baseline=vs(synthetic)),
        "binpack": binpack,
        "group_shape": [main_path.G, main_path.B, main_path.T],
        "card": torch.cuda.get_device_name(0),
    }


def run_all(repeats: int = 1) -> dict:
    """The three protocols on one built model and step, ``repeats`` times in
    turn, the order reversed every other round (synthetic, multi, binpack,
    then binpack, multi, synthetic, ...) so a drift of the host's speed
    falls on every protocol alike. The line carries the median run of each
    protocol, and every run's tokens/s under ``runs``."""
    built = main_path.build_main("cuda")
    gen = torch.Generator(device="cuda").manual_seed(main_path.SEED)
    protocols = {
        "synthetic": lambda: run_synthetic(built, gen),
        "multi": lambda: run_real_pipeline(built, gen, "multi"),
        "binpack": lambda: run_real_pipeline(built, gen, "binpack"),
    }
    runs = {name: [] for name in protocols}
    for r in range(max(1, repeats)):
        for name in (list(protocols) if r % 2 == 0 else list(protocols)[::-1]):
            runs[name].append(protocols[name]())
    median = {name: sorted(rows, key=lambda row: row["value"])[(len(rows) - 1) // 2]
              for name, rows in runs.items()}
    line = summarize(median["synthetic"], median["multi"], median["binpack"])
    line["runs"] = {name: [row["value"] for row in rows] for name, rows in runs.items()}
    line["ms_per_group_runs"] = {name: [row["ms_per_group"] for row in rows]
                                 for name, rows in runs.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=1,
                    help="rounds of the three protocols, in alternating order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_pipeline needs a CUDA device")
    print(json.dumps(run_all(args.repeats)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
