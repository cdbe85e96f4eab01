"""Prefix-generation benchmark engine (twin of
``genomics_lm_tpu/evals/gen_prefix.py``): metrics, protocols, audits,
reports; ``evals/eval_generation_prefix.py`` stays a thin CLI.

Only ``token_nlls`` runs the model: the port's ``codon_gpt.forward`` over
the last ``block_size + 1`` ids at B 1 (the flash forward on the card for a
flash config), then a float32 log-softmax on the host, as JAX's. The
training-stream readers run over the port's ``data/datasets.py::
PackedDataset``. Everything else is a numpy copy:

- deterministic per-sample seeds (sha256 of ``base:gene:k:sample``),
- per-sample quality metrics: AA identity / synonymous rate vs truth,
  stop-behavior score (valid end + early-stop detection), perplexity
  stability (first-vs-last-window NLL drift), non-overlapping 3-gram repeat
  ratio, codon-usage KL agreement vs the training unigram, frame integrity,
  and the weighted GQS composite,
- per-prefix NLL audit vs controls: the generated continuation scored under
  the model against order-shuffled and random-synonymous-substitution
  controls of itself,
- memorization audit: training-set n-gram index + exact-match coverage,
- percentile-bootstrap confidence intervals for protocol summaries,
- replay hookup: hard-cap samples convert into the termination replay
  JSONL schema consumed by ``data/replay.py``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from genomics_lm_torch.generation.genetic_code import (
    AA_TO_CODONS,
    CODON_TABLE as CODON_TO_AA,
    translate_codons_to_aa,
)

STOP_SET = {"TAA", "TAG", "TGA"}

# GQS component weights (reference eval_generation_prefix.py gqs())
GQS_WEIGHTS = {
    "stop_score": 0.30,
    "aa_identity": 0.20,
    "syn_rate": 0.15,
    "ppl_stability": 0.10,
    "no_repeat": 0.10,
    "usage_agree": 0.10,
    "frame_integrity": 0.05,
}

PRESETS = {
    "quick": {"max_genes": 10, "samples": 2, "max_new": 100},
    "standard": {"max_genes": 20, "samples": 3, "max_new": 300},
    "full": {"max_genes": 50, "samples": 5, "max_new": 300},
}


def derive_sample_seed(base_seed: int, gene_idx: int, k: int, sample_id: int) -> int:
    """Deterministic paired seed: sha256("base:gene:k:sample") first 4 bytes."""
    payload = f"{base_seed}:{gene_idx}:{k}:{sample_id}".encode()
    return int.from_bytes(hashlib.sha256(payload).digest()[:4], "big")


def bootstrap_interval(
    values: Sequence[float], *, statistic: str = "mean", seed: int = 0,
    n_resamples: int = 1000,
) -> tuple[float, float]:
    """95% percentile bootstrap of mean/median."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        return float("nan"), float("nan")
    reduce = np.median if statistic == "median" else np.mean
    if arr.size == 1 or n_resamples <= 0:
        v = float(reduce(arr))
        return v, v
    rng = np.random.default_rng(seed)
    draws = arr[rng.integers(0, arr.size, size=(int(n_resamples), arr.size))]
    est = reduce(draws, axis=1)
    lo, hi = np.quantile(est, [0.025, 0.975])
    return float(lo), float(hi)


# --- per-sample metrics ------------------------------------------------------


def aa_identity(truth_aa: Sequence[str], gen_aa: Sequence[str]) -> float:
    n = min(len(truth_aa), len(gen_aa))
    if n == 0:
        return 0.0
    return sum(a == b for a, b in zip(truth_aa[:n], gen_aa[:n])) / n


def synonymous_rate(truth_codons: Sequence[str], gen_codons: Sequence[str]) -> float:
    """Fraction of positions coding the same (non-stop) amino acid."""
    n = min(len(truth_codons), len(gen_codons))
    if n == 0:
        return 0.0
    hits = 0
    for t, g in zip(truth_codons[:n], gen_codons[:n]):
        ta, ga = CODON_TO_AA.get(t, "X"), CODON_TO_AA.get(g, "X")
        if ta == ga and ta != "_":
            hits += 1
    return hits / n


def stop_behavior(gen_codons: Sequence[str], truth_len: int) -> tuple[float, bool, bool]:
    """(stop_score, valid_end, early_stop): 1.0 for a clean terminal stop,
    0.5 for a terminal stop after an early one, otherwise a linear decay in
    the normalized termination-length error (zero past ~20% error)."""
    valid_end = bool(gen_codons) and gen_codons[-1] in STOP_SET
    cutoff = max(1, int(0.9 * truth_len))
    early = any(
        c in STOP_SET and i < cutoff for i, c in enumerate(gen_codons[:-1])
    )
    if valid_end:
        return (0.5 if early else 1.0), valid_end, early
    err = abs(len(gen_codons) - truth_len) / max(1, truth_len)
    return max(0.0, 1.0 - err / 0.2), valid_end, early


def ngram_repeat_ratio(tokens: Sequence[str], n: int = 3) -> float:
    """Repeat fraction over non-overlapping n-gram windows."""
    if len(tokens) < n:
        return 0.0
    grams = [tuple(tokens[i : i + n]) for i in range(0, len(tokens) - n + 1, n)]
    return 1.0 - len(set(grams)) / len(grams) if grams else 0.0


def frame_integrity(gen_codons: Sequence[str]) -> float:
    ok = all(len(c) == 3 and set(c) <= set("ACGT") for c in gen_codons)
    return 1.0 if ok else 0.0


def usage_agreement(gen_ids: Sequence[int], unigram_codon: np.ndarray,
                    codon_mask: np.ndarray) -> float:
    """1 − clipped KL(generated codon usage ‖ training usage), KL0=0.5."""
    counts = np.zeros_like(unigram_codon)
    for t in gen_ids:
        if 0 <= int(t) < counts.size:
            counts[int(t)] += 1
    masked = counts * codon_mask
    total = masked.sum()
    if total <= 0:
        return 0.0
    p = masked / total
    kl = float((p * np.log((p + 1e-12) / (unigram_codon + 1e-12))).sum())
    return float(max(0.0, 1.0 - min(1.0, kl / 0.5)))


def gqs_composite(parts: Dict[str, float]) -> float:
    return 100.0 * sum(w * float(parts[name]) for name, w in GQS_WEIGHTS.items())


# --- model NLL + control comparison -----------------------------------------


@torch.no_grad()
def token_nlls(decoder, ids: Sequence[int]) -> np.ndarray:
    """Per-transition NLL of ``ids`` under the decoder's model (f32)."""
    from genomics_lm_torch.models import codon_gpt

    ids = list(ids)
    if len(ids) < 2:
        return np.zeros(0, np.float32)
    window = ids[-(decoder.cfg.block_size + 1):]
    x = torch.as_tensor([window[:-1]], dtype=torch.long, device=decoder.device)
    logits, _ = codon_gpt.forward(decoder.model, decoder.cfg, x)
    logp = logits[0].float().cpu().numpy()
    logp = logp - logp.max(axis=-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=-1, keepdims=True))
    targets = np.asarray(window[1:], np.int64)
    return -logp[np.arange(len(targets)), targets]


def ppl_stability(nlls: np.ndarray) -> float:
    """exp(−drift/0.02) where drift = mean NLL(last window) − (first window)."""
    if nlls.size < 22:
        return 1.0
    w = min(10, nlls.size // 4)
    drift = max(0.0, float(nlls[-w:].mean() - nlls[:w].mean()))
    return float(np.exp(-drift / 0.02))


def continuation_nll_vs_controls(
    decoder, prefix_ids: Sequence[int], continuation_codons: Sequence[str],
    stoi: Dict[str, int], *, seed: int, n_controls: int = 3,
) -> dict:
    """Mean NLL of the generated continuation vs shuffled and synonymous
    controls built from the same codons. Positive deltas mean the model
    prefers its own continuation — evidence of sequential coherence rather
    than bag-of-codons sampling."""
    rng = np.random.default_rng(seed)
    cont_ids = [stoi[c] for c in continuation_codons if c in stoi]
    if len(cont_ids) < 4:
        return {
            "nll_generated": float("nan"),
            "nll_shuffled": float("nan"),
            "nll_synonymous": float("nan"),
            "delta_shuffled": float("nan"),
            "delta_synonymous": float("nan"),
        }

    def mean_cont_nll(codon_ids: List[int]) -> float:
        full = list(prefix_ids) + codon_ids
        nlls = token_nlls(decoder, full)
        span = min(len(codon_ids), nlls.size)
        return float(nlls[-span:].mean()) if span else float("nan")

    generated = mean_cont_nll(cont_ids)

    shuffled_scores = []
    synonymous_scores = []
    for _ in range(int(n_controls)):
        shuffled = list(cont_ids)
        rng.shuffle(shuffled)
        shuffled_scores.append(mean_cont_nll(shuffled))
        swapped = []
        for codon in continuation_codons:
            aa = CODON_TO_AA.get(codon)
            pool = [c for c in AA_TO_CODONS.get(aa, [codon]) if c in stoi] or [codon]
            chosen = pool[int(rng.integers(len(pool)))]
            swapped.append(stoi.get(chosen, stoi.get(codon, 0)))
        synonymous_scores.append(mean_cont_nll(swapped))

    shuffled_nll = float(np.mean(shuffled_scores))
    synonymous_nll = float(np.mean(synonymous_scores))
    return {
        "nll_generated": generated,
        "nll_shuffled": shuffled_nll,
        "nll_synonymous": synonymous_nll,
        "delta_shuffled": shuffled_nll - generated,
        "delta_synonymous": synonymous_nll - generated,
    }


# --- memorization audit ------------------------------------------------------


def build_train_ngram_indexes(
    npz_paths: Sequence[str | Path],
    ns: Sequence[int],
    *,
    max_tokens: int = 10_000_000,
    fetch_block: int = 256,
) -> dict[int, set]:
    """Exact n-gram indexes over the training token stream, one pass.

    All requested n sizes are filled from a single scan of the dataset
    (block fetches of ``fetch_block`` rows), instead of one full pass and
    one row-at-a-time fetch per n."""
    from genomics_lm_torch.data.datasets import PackedDataset

    indexes: dict[int, set] = {int(n): set() for n in ns}
    if not indexes:
        return indexes
    seen_tokens = 0
    try:
        ds = PackedDataset(list(npz_paths))
    except Exception:
        return indexes
    for lo_row in range(0, len(ds), fetch_block):
        if seen_tokens >= max_tokens:
            break
        rows = list(range(lo_row, min(lo_row + fetch_block, len(ds))))
        x, _ = ds.fetch_batch(rows)
        for r in range(x.shape[0]):
            if seen_tokens >= max_tokens:
                break
            row = [int(t) for t in x[r] if int(t) != 0]
            seen_tokens += len(row)
            for n, index in indexes.items():
                for lo in range(len(row) - n + 1):
                    index.add(tuple(row[lo : lo + n]))
    return indexes


def build_train_ngram_index(
    npz_paths: Sequence[str | Path], n: int, *, max_tokens: int = 10_000_000
) -> set:
    """Single-n convenience wrapper over ``build_train_ngram_indexes``."""
    return build_train_ngram_indexes(npz_paths, [n], max_tokens=max_tokens)[int(n)]


def train_match_coverage(tokens: Sequence[int], n: int, index: set) -> float:
    """Fraction of generated positions inside an exact training n-gram."""
    tokens = [int(t) for t in tokens]
    if len(tokens) < n or not index:
        return 0.0
    covered = np.zeros(len(tokens), bool)
    for lo in range(len(tokens) - n + 1):
        if tuple(tokens[lo : lo + n]) in index:
            covered[lo : lo + n] = True
    return float(covered.mean())


# --- unigram fit -------------------------------------------------------------


def fit_train_unigram(npz_paths: Sequence[str | Path], itos: Sequence[str],
                      *, max_rows: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """(normalized codon unigram, codon mask) over the train stream."""
    from genomics_lm_torch.data.datasets import PackedDataset

    vocab = len(itos)
    counts = np.zeros(vocab, np.float64)
    mask = np.asarray(
        [1.0 if (len(t) == 3 and set(t) <= set("ACGT")) else 0.0 for t in itos]
    )
    try:
        ds = PackedDataset(list(npz_paths))
    except Exception:
        return np.full(vocab, 1.0 / vocab), mask
    for i in range(min(len(ds), max_rows)):
        x, _ = ds.fetch_batch([i])
        ids, freq = np.unique(x[x > 0], return_counts=True)
        counts[ids] += freq
    masked = counts * mask
    total = masked.sum()
    return (masked / total if total > 0 else np.full(vocab, 1.0 / vocab)), mask


# --- sample scoring ----------------------------------------------------------


@dataclass
class ScoredSample:
    protocol: str
    gene_idx: int
    k: int
    sample_id: int
    sample_seed: int
    metrics: Dict[str, float] = field(default_factory=dict)
    info: Dict[str, object] = field(default_factory=dict)
    codons: List[str] = field(default_factory=list)
    continuation: List[str] = field(default_factory=list)


def score_sample(
    *,
    decoder,
    protocol: str,
    gene_idx: int,
    k: int,
    sample_id: int,
    sample_seed: int,
    generated_ids: List[int],
    prefix_len_tokens: int,
    info: dict,
    truth_codons: List[str],
    itos: List[str],
    stoi: Dict[str, int],
    unigram: np.ndarray,
    codon_mask: np.ndarray,
    ngram_indexes: Dict[int, set] | None = None,
    nll_controls: bool = False,
) -> ScoredSample:
    """Full reference metric battery for one generated sample."""
    tokens = [itos[t] if 0 <= t < len(itos) else "?" for t in generated_ids]
    codons = [t for t in tokens if len(t) == 3 and set(t) <= set("ACGT")]
    continuation = codons[min(k, len(codons)):]
    truth_aa = translate_codons_to_aa(truth_codons)
    cont_aa = translate_codons_to_aa(continuation)

    stop_score, valid_end, early = stop_behavior(codons, len(truth_codons))
    nlls = token_nlls(decoder, [stoi.get(c, 0) for c in codons])
    cont_ids = [stoi[c] for c in continuation if c in stoi]
    parts = {
        "aa_identity": aa_identity(truth_aa[k:], cont_aa),
        "syn_rate": synonymous_rate(truth_codons[k:], continuation),
        "stop_score": stop_score,
        "ppl_stability": ppl_stability(nlls),
        "no_repeat": 1.0 - ngram_repeat_ratio(codons, 3),
        "usage_agree": usage_agreement(cont_ids, unigram, codon_mask),
        "frame_integrity": frame_integrity(codons),
    }
    metrics = dict(parts)
    metrics["gqs"] = gqs_composite(parts)
    metrics["valid_end"] = float(valid_end)
    metrics["early_stop"] = float(early)
    metrics["gen_len_codons"] = float(len(codons))
    metrics["had_terminal_stop"] = float(bool(info.get("had_terminal_stop", False)))
    metrics["hit_hard_cap"] = float(bool(info.get("hit_hard_cap", False)))

    full_ids = [stoi[c] for c in codons if c in stoi]
    for n, index in (ngram_indexes or {}).items():
        metrics[f"train_overlap_{n}"] = train_match_coverage(full_ids, n, index)

    if nll_controls:
        metrics.update(
            continuation_nll_vs_controls(
                decoder, generated_ids[:prefix_len_tokens], continuation, stoi,
                seed=sample_seed,
            )
        )

    return ScoredSample(
        protocol=protocol, gene_idx=gene_idx, k=k, sample_id=sample_id,
        sample_seed=sample_seed, metrics=metrics, info=dict(info),
        codons=codons, continuation=continuation,
    )


# --- aggregation -------------------------------------------------------------


def summarize_by_k(samples: List[ScoredSample], k_list: Sequence[int],
                   protocols: Sequence[str], *, base_seed: int,
                   ci_resamples: int = 1000) -> list[dict]:
    """Per-(k, protocol) medians/means with bootstrap CIs."""
    rows = []
    for k in k_list:
        for p_idx, protocol in enumerate(protocols):
            sel = [s for s in samples if s.k == k and s.protocol == protocol]
            if not sel:
                continue
            ci_seed = derive_sample_seed(base_seed, p_idx, k, len(sel))
            gqs_vals = [s.metrics["gqs"] for s in sel]
            len_vals = [s.metrics["gen_len_codons"] for s in sel]
            stop_vals = [s.metrics["had_terminal_stop"] for s in sel]
            cap_vals = [s.metrics["hit_hard_cap"] for s in sel]
            g_lo, g_hi = bootstrap_interval(
                gqs_vals, statistic="median", seed=ci_seed, n_resamples=ci_resamples)
            l_lo, l_hi = bootstrap_interval(
                len_vals, seed=ci_seed + 1, n_resamples=ci_resamples)
            s_lo, s_hi = bootstrap_interval(
                stop_vals, seed=ci_seed + 2, n_resamples=ci_resamples)
            c_lo, c_hi = bootstrap_interval(
                cap_vals, seed=ci_seed + 3, n_resamples=ci_resamples)
            row = {
                "k": k,
                "protocol": protocol,
                "n": len(sel),
                "median_gqs": float(np.median(gqs_vals)),
                "median_gqs_ci_low": g_lo, "median_gqs_ci_high": g_hi,
                "mean_aa_len": float(np.mean(len_vals)),
                "mean_aa_len_ci_low": l_lo, "mean_aa_len_ci_high": l_hi,
                "terminal_stop_rate": float(np.mean(stop_vals)),
                "terminal_stop_rate_ci_low": s_lo, "terminal_stop_rate_ci_high": s_hi,
                "hard_cap_rate": float(np.mean(cap_vals)),
                "hard_cap_rate_ci_low": c_lo, "hard_cap_rate_ci_high": c_hi,
                "mean_aa_identity": float(np.mean(
                    [s.metrics["aa_identity"] for s in sel])),
                "termination_rate": float(np.mean(
                    [s.metrics["valid_end"] for s in sel])),
                "early_stop_rate": float(np.mean(
                    [s.metrics["early_stop"] for s in sel])),
            }
            for extra in ("train_overlap_10", "train_overlap_20",
                          "delta_shuffled", "delta_synonymous"):
                vals = [s.metrics[extra] for s in sel if extra in s.metrics]
                vals = [v for v in vals if np.isfinite(v)]
                if vals:
                    row[f"mean_{extra}"] = float(np.mean(vals))
            rows.append(row)
    return rows


def replay_records(samples: List[ScoredSample], stoi: Dict[str, int],
                   *, window: int = 30,
                   bucket_edges: Sequence[int] = (0, 3, 10, 30)) -> list[dict]:
    """Hard-cap samples → termination-replay JSONL records.

    A hard-cap generation is a missed stop. Following the reference's
    replay script (``build_generated_prefix_replay.py:43-64``), a window
    of tail positions is labeled with the distance bucket each position
    would carry if the stop belonged right at the final generated state:
    ``class = #edges < (boundary − pos)``, so the final position gets
    bucket 0 ("stop imminent") and earlier positions walk up the buckets
    exactly like the training-time labeler
    (``ops/losses.termination_distance_bucket_labels``) would for a real
    stop at the boundary. Labels never reach into the prompt prefix
    (positions < ``s.k``). Schema: ``data/replay.py`` (``ids`` + sparse
    ``labels``).
    """
    if tuple(bucket_edges) != tuple(sorted(bucket_edges)):
        raise ValueError("bucket_edges must be sorted")
    records = []
    for s in samples:
        if not s.metrics.get("hit_hard_cap"):
            continue
        ids = [stoi[c] for c in s.codons if c in stoi]
        boundary = len(ids) - 1
        start = max(int(s.k), boundary - max(0, int(window)))
        if boundary < 1 or start > boundary:
            continue  # nothing generated beyond the prefix
        records.append({
            "ids": ids,
            "labels": [
                {
                    "pos": pos,
                    "class": sum((boundary - pos) > e for e in bucket_edges),
                }
                for pos in range(start, boundary + 1)
            ],
            "origin": {
                "protocol": s.protocol, "gene_idx": s.gene_idx,
                "k": s.k, "sample_id": s.sample_id, "kind": "hard_cap",
            },
        })
    return records


def write_fasta(path: Path, entries: Sequence[tuple[str, str]]) -> None:
    with Path(path).open("w") as fh:
        for name, seq in entries:
            if seq:
                fh.write(f">{name}\n{seq}\n")


def write_csv(path: Path, rows: list[dict]) -> None:
    import csv

    if not rows:
        Path(path).write_text("")
        return
    fields: list[str] = []
    for row in rows:
        for key in row:
            if key not in fields:
                fields.append(key)
    with Path(path).open("w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)


def plot_summary(summary: list[dict], out_dir: Path) -> None:
    """The reference's four metric-vs-k plots (constrained protocol)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [r for r in summary if r["protocol"] == "cds_constrained"]
    if not rows:
        rows = summary
    ks = [r["k"] for r in rows]
    panels = (
        ("termination_rate", "termination_vs_k.png", "Termination vs k"),
        ("median_gqs", "gqs_vs_k.png", "GQS vs k"),
        ("mean_aa_identity", "aa_vs_k.png", "AA identity vs k"),
        ("mean_aa_len", "aa_len_vs_k.png", "AA length vs k"),
    )
    for metric, filename, title in panels:
        fig, ax = plt.subplots()
        ax.plot(ks, [r[metric] for r in rows], marker="o")
        ax.set(xlabel="k", ylabel=metric, title=title)
        fig.tight_layout()
        fig.savefig(out_dir / filename)
        plt.close(fig)


__all__ = [
    "GQS_WEIGHTS",
    "PRESETS",
    "ScoredSample",
    "aa_identity",
    "bootstrap_interval",
    "build_train_ngram_index",
    "build_train_ngram_indexes",
    "continuation_nll_vs_controls",
    "derive_sample_seed",
    "fit_train_unigram",
    "frame_integrity",
    "gqs_composite",
    "ngram_repeat_ratio",
    "plot_summary",
    "ppl_stability",
    "replay_records",
    "score_sample",
    "stop_behavior",
    "summarize_by_k",
    "synonymous_rate",
    "token_nlls",
    "train_match_coverage",
    "usage_agreement",
    "write_csv",
    "write_fasta",
]
