"""Downstream probes (twin of ``genomics_lm_tpu/evals/probes.py``): linear,
k-mer TF-IDF baselines, and an MLP head trained in torch.

The linear and k-mer probes fit on the host with the port's own estimators
(``evals/estimators.py``: ``StandardScaler``, ``LogisticRegression``,
``LinearSVC``, ``TfidfVectorizer`` and ``Pipeline``, sklearn 1.9.0's
arithmetic without sklearn); ``fit_kmer_xgb`` keeps the JAX package's
contract, xgboost or its ``RuntimeError``. ``fit_mlp`` trains a small ReLU MLP on the entry
point's device (the CUDA card unless the caller names another) with
``torch.optim.AdamW`` at optax's ``adamw`` defaults (weight decay 1e-4,
eps 1e-8, every leaf decayed), the batch order from numpy
``default_rng(seed)`` as in JAX, and dropout from a ``torch.Generator``
seeded with ``seed``. Metrics flow through ``evals.metrics.compute_metrics``
in every case.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from genomics_lm_torch.evals.estimators import (
    LinearSVC,
    LogisticRegression,
    TfidfVectorizer,
    standardized,
)
from genomics_lm_torch.evals.metrics import compute_metrics
from genomics_lm_torch.utils.device import resolve_device

OPTAX_ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@dataclass
class ProbeResult:
    model: object
    metrics: Dict[str, float]
    y_pred: np.ndarray
    y_proba: Optional[np.ndarray]


def fit_logreg(X, y, C: float = 1.0, max_iter: int = 2000) -> ProbeResult:
    clf = standardized(LogisticRegression(C=C, max_iter=max_iter))
    clf.fit(X, y)
    y_pred = clf.predict(X)
    try:
        y_proba = clf.predict_proba(X)
    except Exception:
        y_proba = None
    return ProbeResult(clf, compute_metrics(y, y_pred, y_proba), y_pred, y_proba)


def fit_linear_svm(X, y, C: float = 1.0) -> ProbeResult:
    clf = standardized(LinearSVC(C=C))
    clf.fit(X, y)
    y_pred = clf.predict(X)
    try:
        dec = clf.decision_function(X)
        y_proba = dec if isinstance(dec, np.ndarray) else None
    except Exception:
        y_proba = None
    return ProbeResult(clf, compute_metrics(y, y_pred, y_proba), y_pred, y_proba)


class _KmerAnalyzer:
    """Picklable k-mer tokenizer for TfidfVectorizer."""

    def __init__(self, k: int) -> None:
        self.k = k

    def __call__(self, s: str) -> List[str]:
        s = s.strip().upper().replace("U", "T")
        if len(s) < self.k:
            return []
        return [s[i : i + self.k] for i in range(len(s) - self.k + 1)]


@dataclass
class KmerResult:
    vectorizer: object
    model: object
    metrics: Dict[str, float]
    y_pred: np.ndarray
    y_proba: Optional[np.ndarray]


def _tfidf(k: int, tfidf: bool):
    return TfidfVectorizer(analyzer=_KmerAnalyzer(k), use_idf=tfidf)


def fit_kmer_logreg(seqs, y, k: int = 3, tfidf: bool = True, C: float = 1.0,
                    max_iter: int = 2000) -> KmerResult:
    vec = _tfidf(k, tfidf)
    X = vec.fit_transform(seqs)
    clf = LogisticRegression(C=C, max_iter=max_iter)
    clf.fit(X, y)
    y_pred = clf.predict(X)
    try:
        y_proba = clf.predict_proba(X)
    except Exception:
        y_proba = None
    return KmerResult(vec, clf, compute_metrics(y, y_pred, y_proba), y_pred, y_proba)


def fit_kmer_svm(seqs, y, k: int = 3, tfidf: bool = True, C: float = 1.0) -> KmerResult:
    vec = _tfidf(k, tfidf)
    X = vec.fit_transform(seqs)
    clf = LinearSVC(C=C)
    clf.fit(X, y)
    y_pred = clf.predict(X)
    try:
        y_proba = clf.decision_function(X)
    except Exception:
        y_proba = None
    return KmerResult(vec, clf, compute_metrics(y, y_pred, y_proba), y_pred, y_proba)


def fit_kmer_xgb(seqs, y, k: int = 3, tfidf: bool = True, **xgb_kwargs) -> KmerResult:
    try:
        from xgboost import XGBClassifier
    except Exception as exc:
        raise RuntimeError("xgboost not installed; pip install xgboost") from exc
    vec = _tfidf(k, tfidf)
    X = vec.fit_transform(seqs)
    clf = XGBClassifier(
        n_estimators=xgb_kwargs.get("n_estimators", 200),
        max_depth=xgb_kwargs.get("max_depth", 6),
        learning_rate=xgb_kwargs.get("learning_rate", 0.1),
        subsample=0.8,
        colsample_bytree=0.8,
        tree_method=xgb_kwargs.get("tree_method", "auto"),
    )
    clf.fit(X, y)
    y_pred = clf.predict(X)
    try:
        y_proba = clf.predict_proba(X)
    except Exception:
        y_proba = None
    return KmerResult(vec, clf, compute_metrics(y, y_pred, y_proba), y_pred, y_proba)


# --- the MLP head -------------------------------------------------------------


def init_mlp_layers(dims: List[int], seed: int) -> List[Dict[str, np.ndarray]]:
    """The initial draw: per layer ``w`` (a, b) uniform in ±1/sqrt(a) and a
    zero ``b``, JAX's layout and law from a torch generator seeded with
    ``seed`` (JAX draws from ``PRNGKey(seed)``; the streams differ, so a
    parity check hands this function JAX's draw)."""
    gen = torch.Generator().manual_seed(int(seed))
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(a)
        w = (torch.rand((a, b), generator=gen, dtype=torch.float32) * 2 - 1) * bound
        layers.append({"w": w.numpy(), "b": np.zeros((b,), np.float32)})
    return layers


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Keep each entry with probability ``1 - rate``, scaled by ``1 / (1 - rate)``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - rate
    return torch.where(keep, x / (1 - rate), torch.zeros_like(x))


class MLPHead(torch.nn.Module):
    """ReLU MLP; ``layers[i]`` holds ``w`` (in, out) and ``b`` as in JAX."""

    def __init__(self, layers: List[Dict[str, np.ndarray]], dropout: float):
        super().__init__()
        self.dropout = float(dropout)
        self.layers = torch.nn.ParameterList()
        for layer in layers:
            for key in ("w", "b"):
                self.layers.append(torch.nn.Parameter(torch.tensor(np.asarray(layer[key],
                                                                              np.float32))))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        pairs = list(zip(self.layers[0::2], self.layers[1::2]))
        for w, b in pairs[:-1]:
            x = torch.relu(x @ w + b)
            if generator is not None and self.dropout > 0:
                x = dropout(x, self.dropout, generator)
        w, b = pairs[-1]
        return x @ w + b

    def params(self) -> List[Dict[str, np.ndarray]]:
        return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                for w, b in zip(self.layers[0::2], self.layers[1::2])]


@dataclass
class MLPResult:
    params: list
    metrics: Dict[str, float]
    y_pred: np.ndarray
    y_proba: np.ndarray
    predict_fn: object


def fit_mlp(
    X: np.ndarray,
    y: np.ndarray,
    epochs: int = 20,
    lr: float = 1e-3,
    batch_size: int = 64,
    hidden: int = 128,
    depth: int = 1,
    dropout: float = 0.1,
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
) -> MLPResult:
    """Small ReLU MLP classifier head, trained with AdamW on ``device``.

    ``params`` is JAX's list of ``{"w", "b"}`` numpy arrays; ``predict_fn``
    maps new rows to ``(argmax labels, softmax probabilities)``.
    """
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    n_classes = int(y.max()) + 1
    dims = [X.shape[1]] + [hidden] * depth + [n_classes]
    model = MLPHead(init_mlp_layers(dims, seed), dropout).to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, **OPTAX_ADAMW)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    X_dev = torch.as_tensor(X, device=device)
    y_dev = torch.as_tensor(y, device=device)

    rng_np = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng_np.permutation(len(X))
        for start in range(0, len(order), batch_size):
            rows = torch.as_tensor(order[start : start + batch_size], device=device)
            loss = torch.nn.functional.cross_entropy(model(X_dev[rows], gen), y_dev[rows])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    @torch.no_grad()
    def predict_fn(X_new):
        x = torch.as_tensor(np.asarray(X_new, np.float32), device=device)
        logits = model(x)
        return (logits.argmax(dim=1).cpu().numpy(),
                torch.softmax(logits, dim=-1).cpu().numpy())

    y_pred, y_proba = predict_fn(X)
    return MLPResult(model.params(), compute_metrics(y, y_pred, y_proba), y_pred, y_proba,
                     predict_fn)


__all__ = [
    "KmerResult",
    "MLPHead",
    "dropout",
    "MLPResult",
    "ProbeResult",
    "fit_kmer_logreg",
    "fit_kmer_svm",
    "fit_kmer_xgb",
    "fit_linear_svm",
    "fit_logreg",
    "fit_mlp",
    "init_mlp_layers",
]
