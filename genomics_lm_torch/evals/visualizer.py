"""Figures of the analysis reports (the three of
``genomics_lm_tpu/evals/visualizer.py`` that the port draws): the PCA
scatter of an embedding table and an attention heatmap (``evals/analysis.py``)
and the bar chart of one meta metric across runs (``evals/compare_runs.py``),
saved to disk headlessly.

The PCA is numpy's SVD of the centred matrix with sklearn's sign rule:
the coordinates of sklearn's ``PCA(n_components=2)``, without sklearn. Figures
render with matplotlib (Agg); where it is not installed the figure is not
drawn and one line says so, and the reports' JSON is written all the same.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _skipped(out_path) -> None:
    print(f"[visualizer] matplotlib is not installed; {out_path} not drawn", flush=True)


def pca_2d(X: np.ndarray) -> np.ndarray:
    """(N, D) → (N, min(2, D)) coordinates on the leading principal axes,
    each axis signed so that its largest-magnitude loading is positive
    (sklearn's ``svd_flip(U, Vt, u_based_decision=False)``)."""
    X = np.asarray(X, np.float64)
    centred = X - X.mean(axis=0)
    _, _, vt = np.linalg.svd(centred, full_matrices=False)
    vt = vt[:2]
    signs = np.sign(vt[np.arange(len(vt)), np.argmax(np.abs(vt), axis=1)])
    return centred @ (vt * signs[:, None]).T


def plot_embedding_pca(
    X: np.ndarray, labels=None, out_path: str | Path = "pca.png", title: str = "Embedding PCA"
) -> np.ndarray:
    coords = pca_2d(X)
    plt = _plt()
    if plt is None:
        _skipped(out_path)
        return coords
    fig, ax = plt.subplots(figsize=(6, 5))
    if labels is not None:
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            mask = labels == lab
            ax.scatter(coords[mask, 0], coords[mask, 1], s=8, label=str(lab), alpha=0.7)
        if len(np.unique(labels)) <= 12:
            ax.legend(fontsize=7)
    else:
        ax.scatter(coords[:, 0], coords[:, 1], s=8, alpha=0.7)
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.set_title(title)
    plt.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)
    return coords


def plot_run_comparison(runs: list[dict], metric: str, out_path: str | Path) -> None:
    """Bar chart of one meta metric across runs."""
    names, values = [], []
    for run in runs:
        meta = run.get("meta") or {}
        if meta.get(metric) is not None:
            names.append(run["run_id"])
            values.append(float(meta[metric]))
    plt = _plt()
    if plt is None:
        _skipped(out_path)
        return
    fig, ax = plt.subplots(figsize=(max(4, len(names)), 4))
    ax.bar(range(len(names)), values)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel(metric)
    ax.set_title(f"Run comparison: {metric}")
    plt.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)


def plot_attention_heatmap(
    attn: np.ndarray, out_path: str | Path, tokens: list[str] | None = None,
    title: str = "Attention",
) -> None:
    """(T, T) attention heatmap."""
    attn = np.asarray(attn, np.float64)
    plt = _plt()
    if plt is None:
        _skipped(out_path)
        return
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(attn, cmap="viridis")
    fig.colorbar(im, ax=ax)
    if tokens is not None and len(tokens) <= 40:
        ax.set_xticks(range(len(tokens)))
        ax.set_xticklabels(tokens, rotation=90, fontsize=6)
        ax.set_yticks(range(len(tokens)))
        ax.set_yticklabels(tokens, fontsize=6)
    ax.set_title(title)
    plt.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path)
    plt.close(fig)


__all__ = ["pca_2d", "plot_attention_heatmap", "plot_embedding_pca", "plot_run_comparison"]
