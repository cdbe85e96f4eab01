"""Uniform and count-based next-token baselines on a packed split (twin of
``scripts/eval_ppl_baselines.py``, the same flags; host only).

    python -m genomics_lm_torch.evals.eval_ppl_baselines --train_npz train.npz \\
        --eval_npz val.npz [--alpha 1.0] [--out outputs/baselines/ppl_baselines.json]

The perplexity floors and ceilings beside a model's number: uniform over
the vocabulary without PAD, add-``alpha`` unigram fitted on the train
split's non-PAD targets, add-``alpha`` bigram (previous token -> next
token), each scored on the evaluation split's non-PAD targets. The
arithmetic is the script's as written, so the JSON is byte-equal.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train_npz", required=True, help="split to fit the counts on")
    ap.add_argument("--eval_npz", required=True, help="split to score")
    ap.add_argument("--alpha", type=float, default=1.0, help="additive smoothing")
    ap.add_argument("--out", default="outputs/baselines/ppl_baselines.json")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.tokenizers.codon import itos as vocab

    V = len(vocab)

    def targets_of(ds):
        ys = []
        for start in range(0, len(ds), 512):
            _, y = ds.fetch_batch(list(range(start, min(start + 512, len(ds)))))
            ys.append(y.reshape(-1))
        y = np.concatenate(ys)
        return y[y != 0]

    def contexts_of(ds):
        xs, ys = [], []
        for start in range(0, len(ds), 512):
            x, y = ds.fetch_batch(list(range(start, min(start + 512, len(ds)))))
            xs.append(x.reshape(-1))
            ys.append(y.reshape(-1))
        x, y = np.concatenate(xs), np.concatenate(ys)
        keep = y != 0
        return x[keep], y[keep]

    train = PackedDataset(args.train_npz)
    evalset = PackedDataset(args.eval_npz)

    y_train = targets_of(train)
    x_eval, y_eval = contexts_of(evalset)

    # uniform over the vocabulary (excluding PAD)
    uniform_ppl = float(V - 1)

    # unigram with additive smoothing
    counts = np.bincount(y_train, minlength=V).astype(np.float64)
    counts[0] = 0
    probs = (counts + args.alpha) / (counts.sum() + args.alpha * (V - 1))
    probs[0] = 1.0  # never scored
    unigram_nll = float(-np.log(probs[y_eval]).mean())

    # bigram: previous token -> next token
    bigram = np.zeros((V, V), np.float64)
    x_train, y_train_pairs = contexts_of(train)
    np.add.at(bigram, (x_train, y_train_pairs), 1.0)
    bigram_probs = (bigram + args.alpha) / (
        bigram.sum(axis=1, keepdims=True) + args.alpha * V
    )
    bigram_nll = float(-np.log(bigram_probs[x_eval, y_eval]).mean())

    report = {
        "eval_tokens": int(len(y_eval)),
        "uniform": {"perplexity": uniform_ppl},
        "unigram": {"nll": unigram_nll, "perplexity": float(np.exp(unigram_nll))},
        "bigram": {"nll": bigram_nll, "perplexity": float(np.exp(bigram_nll))},
        "alpha": args.alpha,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
