"""The port's own estimators for the representation benchmarks, in numpy and
scipy: the pieces of sklearn that the JAX package's scripts call, so the
port runs them on a machine without sklearn.

Each reproduces sklearn 1.9.0's arithmetic, dtype by dtype:

- ``StandardScaler``: the population variance from float64 accumulators
  (the corrected two-pass sum), a near-constant feature's scale set to 1,
  the transform in the input's float dtype;
- ``train_test_split``: ``ShuffleSplit``'s ``ceil`` test count and one
  ``RandomState(seed).permutation``, test rows first;
- ``StratifiedKFold``: ``_make_test_folds`` (classes by first appearance,
  each fold's share from ``bincount(y_order[i::k])``, one shuffle a class);
- ``StratifiedGroupKFold``: the greedy assignment of shuffled groups,
  stable-sorted by the spread of their class counts, each to the fold that
  keeps the class distribution most even;
- ``LogisticRegression``: the lbfgs objective (the weighted mean half
  log-loss plus ``||w||² / (2 C Σ sample weights)``, the intercept
  unpenalized; ``class_weight="balanced"`` as ``n / (k · bincount)``; the
  symmetric multinomial above two classes) minimized by scipy's L-BFGS-B
  under sklearn's options, the loss computed in the input's float dtype;
- ``Ridge``: the centred closed form on sklearn's ``cholesky`` route, the
  primal system when ``n_features <= n_samples`` and the kernel system
  otherwise;
- ``f1_score`` for binary labels, 0.0 where nothing is predicted or true
  positive (sklearn's ``zero_division`` default).

The L-BFGS-B iterates depend on every float operation, so a fit may stop
an iterate away from sklearn's: the tests hold probabilities to a stated
tolerance and predictions equal.
"""

from __future__ import annotations

import math
import warnings
from collections import defaultdict

import numpy as np
from scipy import linalg, optimize
from scipy.special import expit


def _float_array(X) -> np.ndarray:
    """``X`` as a C-contiguous float32 or float64 array (other dtypes become
    float64), as sklearn's ``check_array(dtype=[float64, float32])``."""
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    return np.ascontiguousarray(X)


def _random_state(seed):
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


# --- scaling -------------------------------------------------------------------


class StandardScaler:
    """Centre each column and divide by its population standard deviation."""

    def fit(self, X, y=None):
        X = _float_array(X)
        n = X.shape[0]
        total = np.sum(X, axis=0, dtype=np.float64)
        self.mean_ = total / n
        centred = X - total / n
        correction = np.sum(centred, axis=0)
        centred **= 2
        self.var_ = (np.sum(centred, axis=0) - correction**2 / n) / n
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = np.sqrt(self.var_)
        self.scale_[constant] = 1.0
        return self

    def transform(self, X):
        X = _float_array(X).copy()
        X -= self.mean_.astype(X.dtype)
        X /= self.scale_.astype(X.dtype)
        return X

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


# --- splits ----------------------------------------------------------------------


def _n_test(n_samples: int, test_size) -> tuple[int, int]:
    if isinstance(test_size, (int, np.integer)):
        if not 0 < test_size < n_samples:
            raise ValueError(f"test_size={test_size} should be positive and smaller than "
                             f"the number of samples {n_samples}")
        n_test = int(test_size)
    else:
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be in the (0, 1) range")
        n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples} and test_size={test_size}, the "
                         "train set is empty")
    return n_train, n_test


def train_test_split(*arrays, test_size=0.25, random_state=None):
    """``[a_train, a_test, b_train, b_test, ...]`` from one permutation."""
    if not arrays:
        raise ValueError("At least one array required as input")
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("arrays of different lengths")
    n_train, n_test = _n_test(n, test_size)
    perm = _random_state(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:n_test + n_train]
    out = []
    for a in arrays:
        a = np.asarray(a)
        out += [a[train], a[test]]
    return out


class _KFold:
    def __init__(self, n_splits: int = 5, *, shuffle: bool = False, random_state=None):
        if n_splits < 2:
            raise ValueError(f"n_splits={n_splits} must be at least 2")
        if not shuffle and random_state is not None:
            raise ValueError("Setting a random_state has no effect since shuffle is False")
        self.n_splits, self.shuffle, self.random_state = int(n_splits), shuffle, random_state

    def split(self, X, y, groups=None):
        n = len(y)
        if self.n_splits > n:
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} "
                             f"greater than the number of samples: n_samples={n}")
        indices = np.arange(n)
        for test in self._test_masks(np.asarray(y), groups):
            yield indices[~test], indices[test]


class StratifiedKFold(_KFold):
    """Folds that keep each class's share, sklearn's ``_make_test_folds``."""

    def _test_masks(self, y, groups):
        rng = _random_state(self.random_state)
        _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
        _, order = np.unique(first, return_inverse=True)
        y_encoded = order[inverse]
        n_classes = len(first)
        counts = np.bincount(y_encoded)
        if np.all(self.n_splits > counts):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater than the number "
                             "of members in each class.")
        if self.n_splits > counts.min():
            warnings.warn(f"The least populated class in y has only {counts.min()} members, "
                          f"which is less than n_splits={self.n_splits}.", UserWarning)
        y_order = np.sort(y_encoded)
        allocation = np.asarray([np.bincount(y_order[i::self.n_splits], minlength=n_classes)
                                 for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds)
            test_folds[y_encoded == k] = folds
        for i in range(self.n_splits):
            yield test_folds == i


class StratifiedGroupKFold(_KFold):
    """Group-disjoint folds that keep the class distribution as even as the
    groups allow (sklearn's greedy assignment)."""

    def _test_masks(self, y, groups):
        if groups is None:
            raise ValueError("The 'groups' parameter should not be None.")
        rng = _random_state(self.random_state)
        _, y_inv, y_cnt = np.unique(y, return_inverse=True, return_counts=True)
        if np.all(self.n_splits > y_cnt):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater than the number "
                             "of members in each class.")
        if self.n_splits > y_cnt.min():
            warnings.warn(f"The least populated class in y has only {y_cnt.min()} members, "
                          f"which is less than n_splits={self.n_splits}.", UserWarning)
        _, groups_inv, groups_cnt = np.unique(np.asarray(groups), return_inverse=True,
                                              return_counts=True)
        if self.n_splits > len(groups_cnt):
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} greater"
                             f" than the number of groups: {len(groups_cnt)}.")
        per_group = np.zeros((len(groups_cnt), len(y_cnt)))
        for class_idx, group_idx in zip(y_inv, groups_inv):
            per_group[group_idx, class_idx] += 1
        per_fold = np.zeros((self.n_splits, len(y_cnt)))
        fold_groups = defaultdict(set)
        if self.shuffle:
            perm = np.arange(len(groups_cnt))
            rng.shuffle(perm)
            per_group = per_group[perm]
            inv_perm = np.empty_like(perm)
            inv_perm[perm] = np.arange(perm.size)
            groups_inv = inv_perm[groups_inv]
        for group_idx in np.argsort(-np.std(per_group, axis=1), kind="stable"):
            counts = per_group[group_idx]
            best, best_eval, best_size = None, np.inf, np.inf
            for i in range(self.n_splits):
                per_fold[i] += counts
                spread = np.mean(np.std(per_fold / y_cnt.reshape(1, -1), axis=0))
                per_fold[i] -= counts
                size = np.sum(per_fold[i])
                if spread < best_eval or (np.isclose(spread, best_eval) and size < best_size):
                    best, best_eval, best_size = i, spread, size
            per_fold[best] += counts
            fold_groups[best].add(group_idx)
        for i in range(self.n_splits):
            yield np.isin(groups_inv, list(fold_groups[i]))


# --- logistic regression -------------------------------------------------------------

LOGREG_TOL = 1e-4  # sklearn's default tol: L-BFGS-B's projected-gradient stop


def _binomial_loss_grad(y: np.ndarray, raw: np.ndarray):
    """Per-row half binomial loss and its gradient in float64, by sklearn's
    branches (``closs_grad_half_binomial``)."""
    r = raw.astype(np.float64)
    y = y.astype(np.float64)
    neg = r <= -2
    e = np.exp(np.where(neg, r, -r))
    loss = np.where(r <= -37, e - y * r,
                    np.where(neg, np.log1p(e) - y * r,
                             np.where(r <= 18, np.log1p(e) + (1 - y) * r, e + (1 - y) * r)))
    grad = np.where(r <= -37, e - y,
                    np.where(neg, ((1 - y) * e - y) / (1 + e), ((1 - y) - y * e) / (1 + e)))
    return loss, grad


def _multinomial_loss_grad(y: np.ndarray, raw: np.ndarray):
    """Per-row half multinomial loss and its gradient, in the dtype of
    ``raw`` as sklearn's ``CyHalfMultinomialLoss`` keeps its buffers."""
    dt = raw.dtype
    top = raw.max(axis=1)
    p = np.exp(raw.astype(np.float64) - top.astype(np.float64)[:, None]).astype(dt)
    total = p.astype(np.float64).sum(axis=1).astype(dt)
    rows = np.arange(raw.shape[0])
    cls = y.astype(np.int64)
    loss = (np.log(total.astype(np.float64)) + top.astype(np.float64)).astype(dt)
    loss = loss - raw[rows, cls]
    p = p / total[:, None]
    onehot = np.zeros_like(p)
    onehot[rows, cls] = 1
    return loss, p - onehot


class LogisticRegression:
    """L2-penalized logistic regression fitted with L-BFGS-B (sklearn's
    ``lbfgs`` solver): binary for two classes, multinomial above."""

    def __init__(self, C: float = 1.0, max_iter: int = 100, class_weight=None):
        if class_weight not in (None, "balanced"):
            raise ValueError(f"class_weight must be None or 'balanced', got {class_weight!r}")
        self.C, self.max_iter, self.class_weight = C, max_iter, class_weight

    def fit(self, X, y):
        X = _float_array(X)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data, "
                             f"but the data contains only one class: {self.classes_[0]!r}")
        n, d = X.shape
        y_ind = np.searchsorted(self.classes_, y)
        sample_weight = None
        if self.class_weight == "balanced":
            sample_weight = np.ones(n, dtype=X.dtype)
            counts = np.bincount(y_ind, weights=sample_weight)
            recip = counts.sum() / (k * counts)
            sample_weight *= recip[y_ind].astype(X.dtype)
        # the penalty's scale takes the weights' sum as a Python float, the loss
        # divides by it in the input's dtype: sklearn's two sums
        sw_sum = n if sample_weight is None else float(np.sum(sample_weight))
        l2 = 1.0 / (self.C * sw_sum)
        binary = k == 2
        if binary:
            target = np.ones(n, dtype=X.dtype)
            target[y_ind != 1] = 0.0
            w0 = np.zeros(d + 1, dtype=X.dtype)
        else:
            target = y_ind.astype(X.dtype)
            w0 = np.zeros((k, d + 1), order="F", dtype=X.dtype).ravel(order="F")
        weight_sum = n if sample_weight is None else np.sum(sample_weight)

        def loss_grad(coef):
            if binary:
                weights, intercept = coef[:-1], coef[-1]
                raw = X @ weights.astype(X.dtype) + np.asarray(intercept, dtype=X.dtype)
                loss, grad_rows = _binomial_loss_grad(target, raw)
            else:
                full = coef.reshape((k, -1), order="F")
                weights, intercept = full[:, :-1], full[:, -1]
                raw = X @ weights.astype(X.dtype).T + intercept.astype(X.dtype)
                loss, grad_rows = _multinomial_loss_grad(target, raw)
            if sample_weight is not None:
                sw = sample_weight.astype(np.float64) if binary else sample_weight
                loss = (sw * loss).astype(X.dtype) if binary else loss * sw
                grad_rows = ((sw * grad_rows).astype(X.dtype) if binary
                             else grad_rows * sw[:, None])
            loss = loss.astype(X.dtype, copy=False)
            grad_rows = grad_rows.astype(X.dtype, copy=False)
            value = float(np.sum(loss) / weight_sum)
            norm2 = weights @ weights if binary else np.dot(np.ravel(weights, order="K"),
                                                            np.ravel(weights, order="K"))
            value += float(0.5 * l2 * norm2)
            grad_rows /= weight_sum
            if binary:
                grad = np.empty_like(coef, dtype=weights.dtype)
                grad[:d] = X.T @ grad_rows + l2 * weights
                grad[-1] = np.sum(grad_rows)
                return value, grad
            grad = np.empty((k, d + 1), dtype=weights.dtype, order="F")
            grad[:, :d] = grad_rows.T @ X + l2 * weights
            grad[:, -1] = np.sum(grad_rows, axis=0)
            return value, grad.ravel(order="F")

        res = optimize.minimize(
            loss_grad, w0, method="L-BFGS-B", jac=True,
            options={"maxiter": self.max_iter, "maxls": 50, "gtol": LOGREG_TOL,
                     "ftol": 64 * np.finfo(float).eps})
        if binary:
            coef = res.x.astype(X.dtype)
            self.coef_, self.intercept_ = coef[:-1][None, :], coef[-1:]
        else:
            coef = np.reshape(res.x, (k, -1), order="F").astype(X.dtype)
            self.coef_, self.intercept_ = coef[:, :-1], coef[:, -1]
        return self

    def decision_function(self, X):
        scores = _float_array(X) @ self.coef_.T + self.intercept_
        return scores.reshape(-1) if scores.shape[1] == 1 else scores

    def predict(self, X):
        scores = self.decision_function(X)
        index = (scores > 0).astype(np.intp) if scores.ndim == 1 else np.argmax(scores, axis=1)
        return self.classes_[index]

    def predict_proba(self, X):
        scores = self.decision_function(X)
        if scores.ndim == 1:
            p = expit(scores)
            return np.stack([1 - p, p], axis=1)
        scores = scores - scores.max(axis=1, keepdims=True)
        np.exp(scores, out=scores)
        return scores / scores.sum(axis=1, keepdims=True)


class StandardizedLogisticRegression:
    """``StandardScaler`` then ``LogisticRegression``: what the JAX package's
    ``fit_logreg`` fits as a sklearn ``Pipeline``."""

    def __init__(self, C: float = 1.0, max_iter: int = 2000, class_weight=None):
        self.scaler = StandardScaler()
        self.model = LogisticRegression(C=C, max_iter=max_iter, class_weight=class_weight)

    def fit(self, X, y):
        self.model.fit(self.scaler.fit_transform(X), y)
        return self

    def predict(self, X):
        return self.model.predict(self.scaler.transform(X))

    def predict_proba(self, X):
        return self.model.predict_proba(self.scaler.transform(X))


# --- ridge ------------------------------------------------------------------------------


class Ridge:
    """Least squares with an L2 penalty ``alpha`` and an intercept."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def fit(self, X, y):
        X = _float_array(X).copy()
        y = np.array(y, dtype=X.dtype)
        X_offset = np.average(X, axis=0).astype(X.dtype, copy=False)
        X -= X_offset
        y_offset = np.average(y, axis=0)
        y -= y_offset
        ravel = y.ndim == 1
        Y = y.reshape(-1, 1) if ravel else y
        alpha = np.asarray(self.alpha, dtype=X.dtype).ravel()
        n_samples, n_features = X.shape
        if n_features > n_samples:
            K = X @ X.T
            K.flat[:: n_samples + 1] += alpha[0]
            coef = (X.T @ linalg.solve(K, Y, assume_a="pos", overwrite_a=False)).T
        else:
            A = X.T @ X
            A.flat[:: n_features + 1] += alpha[0]
            coef = linalg.solve(A, X.T @ Y, assume_a="pos", overwrite_a=True).T
        coef = coef.ravel() if ravel else coef
        self.coef_ = coef.astype(X_offset.dtype, copy=False)
        self.intercept_ = y_offset - (X_offset @ self.coef_ if ravel
                                      else X_offset @ self.coef_.T)
        return self

    def predict(self, X):
        X = _float_array(X)
        return X @ (self.coef_ if self.coef_.ndim == 1 else self.coef_.T) + self.intercept_


# --- metrics --------------------------------------------------------------------------------


def f1_score(y_true, y_pred) -> float:
    """Binary F1 of label 1; 0.0 where precision and recall are both undefined
    or the true positives are none."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = set(np.unique(y_true).tolist()) | set(np.unique(y_pred).tolist())
    if not labels <= {0, 1}:
        raise ValueError(f"binary labels 0/1 expected, got {sorted(labels)}")
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    denom = int(np.sum(y_true == 1)) + int(np.sum(y_pred == 1))
    return float(2 * tp / denom) if denom else 0.0


__all__ = ["LogisticRegression", "Ridge", "StandardScaler", "StandardizedLogisticRegression",
           "StratifiedGroupKFold", "StratifiedKFold", "f1_score", "train_test_split"]
