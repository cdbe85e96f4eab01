"""Manifest-bound intrinsic evaluation of a run on a frozen split: model
NLL/PPL, the Markov baselines with paired-bootstrap margins, and the
context ablation (twin of ``scripts/evaluate_test.py``, the same flags
plus ``--device``).

    python -m genomics_lm_torch.evals.evaluate_test <run_id> --test_npz test.npz \\
        [--train_npz train.npz] [--bootstrap 1000] [--context_ablation] \\
        [--dataset_manifest manifest.json [--require_scientific_valid]] \\
        [--run_root runs] [--out report.json] [--device cpu]

- The model's exact token-weighted NLL on the split (``evaluate_perplexity``,
  batches of ``--batch_size`` in dataset row order, dropout off, on the
  card unless ``--device`` names another).
- With ``--train_npz``: uniform/unigram/bigram/trigram baselines fitted on
  the train split with the trigram history reset at ``<SEP>``
  (``evals/markov.py``), the best simple model, and whether the model beats
  it; with ``--bootstrap N`` also each margin's paired-bootstrap CI over the
  split's packed rows (``evals/significance.py``), after checking that the
  model's and the baselines' per-row token counts agree.
- ``--dataset_manifest`` binds the split to a frozen manifest and the
  checkpoint's recorded dataset to it (``evals/provenance.py``);
  ``--require_scientific_valid`` fails unless the manifest is scientific.

Writes ``<run>/scores/test_evaluation.json`` (or ``--out``) with JAX's
keys, and prints the model block, the best simple model and each margin,
then one ``[evaluate_test] seconds`` line with the time of each part.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--test_npz", required=True)
    ap.add_argument("--train_npz", default=None, help="fit Markov baselines on this split")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--context_ablation", action="store_true")
    ap.add_argument("--bootstrap", type=int, default=0, metavar="N",
                    help="paired bootstrap resamples for CIs on every model-vs-baseline "
                         "margin (needs --train_npz; 0 disables)")
    ap.add_argument("--bootstrap_seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dataset_manifest", default=None,
                    help="frozen dataset manifest to bind this evaluation to")
    ap.add_argument("--require_scientific_valid", action="store_true",
                    help="fail unless the manifest is marked scientific_valid and matches "
                         "the checkpoint's dataset id")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def split_xy(dataset) -> tuple[np.ndarray, np.ndarray]:
    """A packed split's (X, Y) rows in dataset order, fetched 512 at a time."""
    xs, ys = [], []
    for i in range(0, len(dataset), 512):
        x, y = dataset.fetch_batch(list(range(i, min(i + 512, len(dataset)))))
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def _provenance(args, run_dir: Path) -> dict | None:
    if not (args.dataset_manifest or args.require_scientific_valid):
        return None
    from genomics_lm_torch.evals.playground import resolve_checkpoint
    from genomics_lm_torch.evals.provenance import (
        EvaluationProvenanceError,
        bind_checkpoint_dataset,
        bind_dataset_manifest,
    )
    from genomics_lm_torch.training.checkpoints import load_checkpoint_meta

    if not args.dataset_manifest:
        raise EvaluationProvenanceError("--require_scientific_valid needs --dataset_manifest")
    _, manifest_prov = bind_dataset_manifest(
        args.dataset_manifest,
        expected_artifacts={"test_tokens": args.test_npz},
        require_scientific=args.require_scientific_valid,
    )
    # metadata only: the weights are loaded once, by the caller
    ckpt_cfg = dict(load_checkpoint_meta(resolve_checkpoint(run_dir, args.checkpoint))
                    .get("cfg", {}))
    return {
        "dataset_manifest": manifest_prov,
        "checkpoint_dataset": bind_checkpoint_dataset(ckpt_cfg, manifest_prov),
    }


def evaluate(args) -> tuple[dict, Path, dict]:
    """``(report, out_path, seconds)``: the report JAX's script writes, where
    it goes, and the seconds of each part (model, baselines, bootstrap,
    context ablation)."""
    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals import markov
    from genomics_lm_torch.evals.perplexity import (
        context_ablation,
        evaluate_perplexity,
        per_row_model_nll,
    )
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.evals.significance import paired_bootstrap_margins
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    provenance_block = _provenance(args, run_dir)  # fail closed before any model work
    model, cfg, itos, _ = load_codon_model(run_dir, args.checkpoint, device=args.device)
    cfg = cfg.replace(dropout=0.0)
    seconds = {}

    t0 = time.perf_counter()
    report = {
        "run_id": run_dir.name,
        "test_npz": str(args.test_npz),
        "model": evaluate_perplexity(model, cfg, args.test_npz, batch_size=args.batch_size),
    }
    seconds["model"] = time.perf_counter() - t0
    if args.train_npz:
        t0 = time.perf_counter()
        test_ds = PackedDataset(args.test_npz)
        test_xy = split_xy(test_ds)
        reset_ids = frozenset(i for i, tok in enumerate(itos) if tok == "<SEP>")
        counts = markov.fit_baselines(*split_xy(PackedDataset(args.train_npz)), len(itos),
                                      args.alpha, reset_token_ids=reset_ids)
        results, tokens, best = markov.evaluate_baselines(
            *test_xy, counts, len(itos), args.alpha, reset_token_ids=reset_ids)
        report["baselines"] = results
        report["baseline_tokens"] = tokens
        report["best_simple_model"] = best
        report["beats_best_simple"] = (
            report["model"]["nll"] < results[best]["cross_entropy_nats"])
        seconds["baselines"] = time.perf_counter() - t0
        if args.bootstrap:
            t0 = time.perf_counter()
            model_rows, tokens_rows = per_row_model_nll(model, cfg, test_ds,
                                                        batch_size=args.batch_size)
            base_rows, base_tokens_rows = markov.per_row_baseline_nll(
                *test_xy, counts, len(itos), args.alpha, reset_token_ids=reset_ids)
            if not np.array_equal(tokens_rows, base_tokens_rows):
                raise RuntimeError(
                    "model/baseline per-row token counts disagree — the paired bootstrap "
                    "would be misaligned")
            report["margins"] = paired_bootstrap_margins(
                model_rows, tokens_rows, base_rows,
                n_boot=args.bootstrap, seed=args.bootstrap_seed)
            report["margins_protocol"] = (
                f"paired bootstrap over {int((tokens_rows > 0).sum())} packed "
                f"rows ({int(tokens_rows.sum())} non-PAD tokens), "
                f"{args.bootstrap} resamples, seed {args.bootstrap_seed}; "
                "margin = baseline - model corpus NLL (nats/token, "
                "positive = model better)")
            seconds["bootstrap"] = time.perf_counter() - t0
    if args.context_ablation:
        t0 = time.perf_counter()
        report["context_ablation"] = context_ablation(model, cfg, args.test_npz,
                                                      batch_size=args.batch_size)
        seconds["context_ablation"] = time.perf_counter() - t0
    if provenance_block is not None:
        report["provenance"] = provenance_block
    out_path = Path(args.out) if args.out else run_dir / "scores" / "test_evaluation.json"
    return report, out_path, seconds


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    report, out_path, seconds = evaluate(args)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report["model"], indent=2))
    if "baselines" in report:
        print("best simple model:", report["best_simple_model"],
              "| model beats it:", report["beats_best_simple"])
    for name, m in report.get("margins", {}).items():
        print(f"margin vs {name}: {m['margin_nats']:+.4f} nats "
              f"[{m['ci_low']:+.4f}, {m['ci_high']:+.4f}] "
              f"{'EXCLUDES 0' if m['excludes_zero'] else 'includes 0'}")
    print("[evaluate_test] seconds " + json.dumps(seconds), flush=True)
    return 0


__all__ = ["evaluate", "main", "parser", "split_xy"]


if __name__ == "__main__":
    raise SystemExit(main())
