"""Classifier metric suite (twin of ``genomics_lm_tpu/evals/metrics.py``):
point estimates plus class-stratified bootstrap 95% CIs.

Accuracy, balanced accuracy, macro-F1, one-vs-rest AUROC and macro AUPRC,
computed in numpy with sklearn's definitions, so the MLP probe can report
its metrics on a machine without sklearn:

- macro-F1 over the union of true and predicted labels, an undefined ratio
  counted as 0; balanced accuracy averages the recall of the classes present
  in ``y_true``;
- AUROC is the trapezoid under the ROC curve at the distinct scores (tied
  scores count half); AUPRC is average precision over the distinct scores;
- a 1-D ``proba`` is a binary score: AUROC takes the larger of two labels as
  positive, average precision label 1 and refuses a two-label ``y_true``
  without it; a 2-D ``proba`` is scored one-vs-rest over its columns and
  averaged;
- as in the sklearn release the JAX package runs against, a column (or a
  binary ``y_true``) with one class only gives a NaN AUROC and its average
  precision is 0 with no positive, 1 with no negative; where sklearn raises
  (a 1-D score over three or more labels, a label beyond ``proba``'s
  columns, the missing positive label above) the pair of ranking metrics is
  omitted, as JAX's ``except`` omits it.

The confusion and calibration plots take their numbers from numpy too;
without matplotlib a figure is skipped with one printed line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

CI_LO_Q = 0.025
CI_HI_Q = 0.975


# --- small IO helpers shared by probe/classifier entry points ---------------


def ensure_dir(p) -> Path:
    out = Path(p)
    out.mkdir(parents=True, exist_ok=True)
    return out


def load_yaml(path) -> dict:
    import yaml

    return yaml.safe_load(Path(path).read_text()) or {}


def save_json(path, data: dict) -> None:
    target = Path(path)
    ensure_dir(target.parent)
    target.write_text(json.dumps(data, indent=2, sort_keys=True))


def save_npz(path, **arrays) -> None:
    target = Path(path)
    ensure_dir(target.parent)
    np.savez_compressed(target, **arrays)


def load_npz(path) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=True) as blob:
        return {name: blob[name] for name in blob.files}


@dataclass
class EmbeddingPack:
    """Sequence embeddings plus optional labels/ids."""

    X: np.ndarray
    y: Optional[np.ndarray] = None
    ids: Optional[List[str]] = None


# --- scoring ----------------------------------------------------------------


class _Undefined(ValueError):
    """A ranking metric sklearn refuses for these labels."""


def _labels_to_indicator(y: np.ndarray, n_classes: int) -> np.ndarray:
    eye = np.eye(n_classes, dtype=np.float32)
    return eye[np.asarray(y, dtype=np.int64)]


def _threshold_counts(positive: np.ndarray, score: np.ndarray):
    """(fps, tps) at each distinct score, highest first (float64)."""
    score = np.asarray(score)
    if not np.all(np.isfinite(score)):
        raise _Undefined("non-finite score")
    order = np.argsort(-score, kind="stable")
    score, positive = score[order], positive[order].astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(score))[0], [score.size - 1]])
    tps = np.cumsum(positive, dtype=np.float64)[idx]
    return 1 + idx.astype(np.float64) - tps, tps


def _auroc(positive: np.ndarray, score: np.ndarray) -> float:
    if np.unique(positive).size != 2:
        return float("nan")
    fps, tps = _threshold_counts(positive, score)
    if fps.size > 2:  # drop collinear points, as sklearn's roc_curve does
        keep = np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]])
        fps, tps = fps[keep], tps[keep]
    fpr = np.concatenate([[0.0], fps]) / fps[-1]
    tpr = np.concatenate([[0.0], tps]) / tps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def _average_precision(positive: np.ndarray, score: np.ndarray) -> float:
    fps, tps = _threshold_counts(positive, score)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _add_ranking_scores(scores: Dict[str, float], true: np.ndarray,
                        proba: np.ndarray) -> None:
    """AUROC, then macro AUPRC, into ``scores``; raises ``_Undefined`` where
    sklearn raises, keeping what was already added (as JAX's ``try`` does)."""
    if proba.ndim == 1:
        labels = np.unique(true)
        if labels.size > 2:
            raise _Undefined("a 1-D score over more than two labels")
        scores["auroc"] = _auroc((true == labels[-1]).astype(np.int64), proba)
        if labels.size == 2 and 1 not in labels:
            raise _Undefined("pos_label=1 is not a valid label")
        scores["macro_auprc"] = _average_precision(true == 1, proba)
        return
    try:
        indicator = _labels_to_indicator(true, proba.shape[1])
    except IndexError as exc:
        raise _Undefined(str(exc)) from exc
    columns = range(proba.shape[1])
    scores["auroc"] = float(np.mean([_auroc(indicator[:, c], proba[:, c]) for c in columns]))
    scores["macro_auprc"] = float(np.mean(
        [_average_precision(indicator[:, c] == 1, proba[:, c]) for c in columns]))


def _score_all(true, pred, proba) -> Dict[str, float]:
    """One pass of every metric that applies to this prediction shape.

    The ranking pair is omitted where sklearn refuses it (module docstring);
    the CI then aggregates over the resamples where the metric existed.
    """
    true, pred = np.asarray(true), np.asarray(pred)
    if true.size == 0 or true.shape != pred.shape:
        raise ValueError(f"y_true {true.shape} and y_pred {pred.shape}: need equal, non-empty")
    labels = np.union1d(true, pred)
    tp = np.asarray([np.sum((true == c) & (pred == c)) for c in labels], np.float64)
    true_sum = np.asarray([np.sum(true == c) for c in labels], np.float64)
    pred_sum = np.asarray([np.sum(pred == c) for c in labels], np.float64)
    recall = tp[true_sum > 0] / true_sum[true_sum > 0]
    scores: Dict[str, float] = {
        "accuracy": float(np.mean(true == pred)),
        "balanced_accuracy": float(np.mean(recall)),
        "macro_f1": float(np.mean(2 * tp / (true_sum + pred_sum))),
    }
    if proba is None:
        return scores
    try:
        _add_ranking_scores(scores, true, np.asarray(proba))
    except _Undefined:
        pass
    return scores


def _resamples(
    y_true: np.ndarray, n_resamples: int, seed: int
) -> Iterator[np.ndarray]:
    """Class-stratified bootstrap index draws (each class keeps its count)."""
    rng = np.random.default_rng(seed)
    class_pools = [np.flatnonzero(y_true == c) for c in np.unique(y_true)]
    for _ in range(n_resamples):
        draw = np.concatenate(
            [rng.choice(pool, size=pool.size, replace=True) for pool in class_pools]
        )
        rng.shuffle(draw)
        yield draw


def compute_metrics(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    y_proba: Optional[np.ndarray] = None,
    bootstrap: bool = False,
    n_resamples: int = 1000,
    seed: int = 42,
) -> Dict[str, float]:
    """Point metrics, plus ``<name>_ci_lower``/``_ci_upper`` percentile
    bounds from a stratified bootstrap when ``bootstrap`` is set."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    report = _score_all(y_true, y_pred, y_proba)

    if not bootstrap or y_true.size == 0:
        return report

    distribution: Dict[str, list] = {name: [] for name in report}
    for idx in _resamples(y_true, n_resamples, seed):
        sample_scores = _score_all(
            y_true[idx], y_pred[idx], None if y_proba is None else y_proba[idx])
        for name, value in sample_scores.items():
            if name in distribution:
                distribution[name].append(value)

    for name, values in distribution.items():
        if not values:
            continue
        values.sort()  # a list sort, as JAX's: NaN entries stay where it leaves them
        report[f"{name}_ci_lower"] = float(values[int(len(values) * CI_LO_Q)])
        report[f"{name}_ci_upper"] = float(values[int(len(values) * CI_HI_Q)])
    return report


# --- plots ------------------------------------------------------------------


def confusion_matrix(y_true, y_pred, normalize: bool = True):
    """(classes, matrix): rows true, columns predicted, over the union of
    labels; with ``normalize`` each row sums to 1 (a class never true stays 0)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    classes = np.unique(np.concatenate([y_true, y_pred]))
    t = np.searchsorted(classes, y_true)
    p = np.searchsorted(classes, y_pred)
    matrix = np.zeros((classes.size, classes.size), np.float64)
    np.add.at(matrix, (t, p), 1.0)
    if normalize:
        rows = matrix.sum(axis=1, keepdims=True)
        matrix = np.divide(matrix, rows, out=np.zeros_like(matrix), where=rows > 0)
    return classes, matrix


def calibration_bins(hits, confidence, n_bins: int = 10):
    """(fraction positive, mean predicted) over the non-empty of ``n_bins``
    uniform bins on [0, 1] (sklearn's ``calibration_curve``)."""
    hits = np.asarray(hits, np.float64)
    confidence = np.asarray(confidence, np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ids = np.searchsorted(edges[1:-1], confidence)
    total = np.bincount(ids, minlength=n_bins)
    nonzero = total != 0
    frac = np.bincount(ids, weights=hits, minlength=n_bins)[nonzero] / total[nonzero]
    mean = np.bincount(ids, weights=confidence, minlength=n_bins)[nonzero] / total[nonzero]
    return frac, mean


def _finish(plt, fig, out_path) -> None:
    plt.tight_layout()
    ensure_dir(Path(out_path).parent)
    plt.savefig(out_path)
    plt.close(fig)


def _skipped(out_path) -> None:
    print(f"[metrics] matplotlib is not installed; {out_path} not drawn", flush=True)


def plot_confusion(y_true, y_pred, out_path, normalize: bool = True) -> None:
    """Heatmap of the (optionally row-normalized) confusion matrix."""
    from genomics_lm_torch.evals.visualizer import _plt

    classes, matrix = confusion_matrix(y_true, y_pred, normalize)
    plt = _plt()
    if plt is None:
        return _skipped(out_path)
    fig, ax = plt.subplots(figsize=(6, 5))
    image = ax.imshow(matrix, cmap="Blues")
    fig.colorbar(image, ax=ax)
    ax.set(
        xlabel="Predicted",
        ylabel="True",
        xticks=range(len(classes)),
        yticks=range(len(classes)),
        title="Confusion Matrix" + (" (normalized)" if normalize else ""),
    )
    ax.set_xticklabels(classes, rotation=45, ha="right")
    ax.set_yticklabels(classes)
    _finish(plt, fig, out_path)


def plot_calibration(y_true, y_proba, out_path, n_bins: int = 10) -> None:
    """Reliability diagram; multiclass reduces to top-1 confidence vs hit.

    Scores outside [0, 1] are squashed through a sigmoid first (logit
    inputs), as in JAX.
    """
    from genomics_lm_torch.evals.visualizer import _plt

    proba = np.asarray(y_proba)
    if proba.ndim > 1 and proba.shape[1] > 1:
        confidence = proba.max(axis=1)
        hits = (np.asarray(y_true) == proba.argmax(axis=1)).astype(int)
    else:
        confidence = proba.reshape(-1)
        hits = np.asarray(y_true)
    if confidence.min() < 0.0 or confidence.max() > 1.0:
        confidence = 1.0 / (1.0 + np.exp(-confidence))

    frac_positive, mean_predicted = calibration_bins(hits, confidence, n_bins)
    plt = _plt()
    if plt is None:
        return _skipped(out_path)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(mean_predicted, frac_positive, marker="o", label="model")
    ax.plot([0, 1], [0, 1], linestyle="--", color="gray", label="perfect")
    ax.set(xlabel="Predicted probability", ylabel="True frequency",
           title="Calibration curve")
    ax.legend()
    _finish(plt, fig, out_path)


__all__ = [
    "EmbeddingPack",
    "calibration_bins",
    "compute_metrics",
    "confusion_matrix",
    "ensure_dir",
    "load_npz",
    "load_yaml",
    "plot_calibration",
    "plot_confusion",
    "save_json",
    "save_npz",
]
