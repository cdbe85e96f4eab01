"""Probe hidden states for extended DNA-shape awareness (twin of
``scripts/probe_structural_awareness.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.probe_structural_awareness <run_id> \\
        [--n_sequences 48] [--seq_len_codons 24] [--seed 0] [--out awareness.json] \\
        [--run_root runs] [--device cpu]

Motif-biased random CDS (seeded numpy), each through ``forward_hidden`` at
batch 1 (the flash forward on the card); the per-codon means of the
heuristic shape parameters MGW/Roll/EP (``models/biophysics.py``) and
ProT/HelT/Slide (``extended_shape``) are regressed from the codon positions'
hidden states by ``Ridge(alpha=1)`` on a 75/25 ``train_test_split``
(``evals/estimators.py``). Writes ``--out`` (default
``<run>/scores/structural_awareness.json``): R² a parameter, their mean and
the tokens.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

MOTIFS = ["AAAA", "GGGG", "CCCC", "TTTT", "GGCC", ""]


def extended_shape(dna: str) -> dict[str, list[float]]:
    """ProT / HelT / Slide heuristics (same pentamer-window style as the
    core table: A-tracts → high negative propeller twist, GC steps → higher
    helical twist and positive slide)."""
    prot, helt, slide = [], [], []
    for i in range(len(dna)):
        window = dna[max(0, i - 2) : min(len(dna), i + 3)]
        if "AAAA" in window or "TTTT" in window:
            p, h, s = -15.0, 34.0, -0.8
        elif "GC" in window or "CG" in window:
            p, h, s = -5.0, 36.0, 0.5
        elif "GG" in window or "CC" in window:
            p, h, s = -7.0, 35.0, 0.2
        else:
            p, h, s = -10.0, 34.5, -0.2
        prot.append(p)
        helt.append(h)
        slide.append(s)
    return {"ProT": prot, "HelT": helt, "Slide": slide}


def motif_biased_dna(rng: np.random.Generator, L: int, motifs: list[str]) -> str:
    """``3 L`` random bases with ``max(1, L // 4)`` draws of ``motifs``
    written over them (an empty draw writes nothing)."""
    base = list(rng.choice(list("ACGT"), 3 * L))
    for _ in range(max(1, L // 4)):
        m = motifs[rng.integers(len(motifs))]
        if m:
            pos = int(rng.integers(0, 3 * L - len(m)))
            base[pos : pos + len(m)] = list(m)
    return "".join(base)


@torch.no_grad()
def codon_hidden(model, cfg, dna: str) -> np.ndarray:
    """Float32 final-norm hidden states of ``[BOS] + codons`` at batch 1, the
    BOS position dropped."""
    from genomics_lm_torch.models.codon_gpt import forward_hidden
    from genomics_lm_torch.tokenizers.codon import stoi
    from genomics_lm_torch.utils.device import module_device

    ids = [1] + [stoi[dna[i : i + 3]] for i in range(0, len(dna) - len(dna) % 3, 3)]
    idx = torch.tensor([ids], dtype=torch.long, device=module_device(model))
    return forward_hidden(model, cfg, idx)[0, 1:].float().cpu().numpy()


def ridge_r2(X_tr, X_te, y_tr, y_te):
    """Ridge(alpha=1) predictions on the held-out rows and their R²."""
    from genomics_lm_torch.evals.estimators import Ridge

    pred = Ridge(alpha=1.0).fit(X_tr, y_tr).predict(X_te)
    ss_res = float(((y_te - pred) ** 2).sum())
    ss_tot = float(((y_te - y_te.mean()) ** 2).sum())
    return pred, ss_res, ss_tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--n_sequences", type=int, default=48)
    ap.add_argument("--seq_len_codons", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.estimators import train_test_split
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.models.biophysics import get_theoretical_shape
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, device=args.device)
    cfg = cfg.replace(dropout=0.0)

    rng = np.random.default_rng(args.seed)
    L = args.seq_len_codons
    feats, targets = [], {k: [] for k in ("MGW", "Roll", "EP", "ProT", "HelT", "Slide")}
    for _ in range(args.n_sequences):
        dna = motif_biased_dna(rng, L, MOTIFS)
        feats.append(codon_hidden(model, cfg, dna))
        shapes = {**get_theoretical_shape(dna), **extended_shape(dna)}
        for name, values in shapes.items():
            targets[name].append(np.asarray(values, np.float64).reshape(L, 3).mean(axis=1))

    X = np.concatenate(feats)
    report = {}
    for name, rows in targets.items():
        y = np.concatenate(rows)
        if float(y.std()) < 1e-9:
            report[name] = {"r2": None, "note": "constant target"}
            continue
        X_tr, X_te, y_tr, y_te = train_test_split(X, y, test_size=0.25, random_state=args.seed)
        _, ss_res, ss_tot = ridge_r2(X_tr, X_te, y_tr, y_te)
        report[name] = {"r2": 1.0 - ss_res / ss_tot}

    r2s = [v["r2"] for v in report.values() if v.get("r2") is not None]
    summary = {"params": report, "mean_r2": float(np.mean(r2s)) if r2s else None,
               "n_tokens": int(X.shape[0])}
    out = Path(args.out) if args.out else run_dir / "scores" / "structural_awareness.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2) + "\n")
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
