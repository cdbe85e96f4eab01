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
  under sklearn's options, the loss computed in the input's float dtype.
  A ``scipy.sparse`` input stays sparse: its products are scipy's CSR
  products, the ones sklearn's loss takes on the same matrix, so the sums
  run in sklearn's order;
- ``Ridge``: the centred closed form on sklearn's ``cholesky`` route, the
  primal system when ``n_features <= n_samples`` and the kernel system
  otherwise;
- ``LinearSVC``: liblinear's squared hinge with an L2 penalty, the bias a
  penalized feature of value 1 (``intercept_scaling`` 1), more than two
  classes one-vs-rest, the rows grouped by class as liblinear groups them;
  ``dual="auto"`` as sklearn's ``_validate_dual_parameter``: with at least
  as many rows as features, liblinear's deterministic primal trust-region
  Newton method (``tron.cpp``: conjugate gradients in the trust region, its
  stop at ``tol · max(min(pos, neg), 1) / n`` of the first gradient norm),
  else its dual coordinate descent with shrinking, each sweep's order drawn
  from the Mersenne Twister that sklearn seeds with
  ``random_state.randint(2**31 - 1)`` through liblinear's bounded draw;
- ``Pipeline``: named steps, each transformer fitted in turn and the last
  step's ``predict``, ``predict_proba`` and ``decision_function`` where it
  has them;
- ``TfidfVectorizer`` with a callable analyzer: counts in the order terms
  first appear, the vocabulary sorted by term, ``smooth_idf``
  ``log((1 + n) / (1 + df)) + 1``, each row divided by its L2 norm, summed
  in the order of the row's stored entries; float64 ``scipy.sparse`` CSR;
- ``f1_score`` for binary labels, 0.0 where nothing is predicted or true
  positive (sklearn's ``zero_division`` default); ``confusion_matrix``.

The L-BFGS-B and liblinear iterates depend on every float operation, so a
fit may stop an iterate away from sklearn's: the tests hold probabilities
and decisions to stated tolerances and predictions equal.
"""

from __future__ import annotations

import math
import warnings
from collections import defaultdict

import numpy as np
from scipy import linalg, optimize, sparse
from scipy.linalg import blas
from scipy.special import expit


def _float_array(X):
    """``X`` as a C-contiguous float32 or float64 array (other dtypes become
    float64), as sklearn's ``check_array(dtype=[float64, float32])``; a
    sparse matrix as CSR of such a dtype."""
    if sparse.issparse(X):
        X = sparse.csr_matrix(X)
        return X if X.dtype in (np.float32, np.float64) else X.astype(np.float64)
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


# --- linear SVM (liblinear) ------------------------------------------------------------

SVC_TOL = 1e-4  # LinearSVC's default tol: liblinear's eps
SVC_MAX_ITER = 1000
INT_MAX = 2**31 - 1  # np.iinfo("i").max, the bound of the seed sklearn draws


class _MersenneTwister:
    """The 32-bit draws of ``std::mt19937(seed)`` (numpy's legacy seeding runs
    the same ``init_genrand``), read through liblinear's ``bounded_rand_int``."""

    def __init__(self, seed: int):
        self._rs = np.random.RandomState(seed)
        self._buf, self._pos = np.empty(0, np.uint32), 0

    def _next(self) -> int:
        if self._pos == len(self._buf):
            self._buf, self._pos = self._rs.randint(0, 2**32, 4096, dtype=np.uint32), 0
        self._pos += 1
        return int(self._buf[self._pos - 1])

    def bounded(self, bound: int) -> int:
        """Lemire's draw in ``[0, bound)``, sklearn's ``newrand.h``."""
        m = self._next() * bound
        low = m & 0xFFFFFFFF
        if low < bound:
            t = (-bound) & 0xFFFFFFFF
            if t >= bound:
                t -= bound
                if t >= bound:
                    t %= bound
            while low < t:
                m = self._next() * bound
                low = m & 0xFFFFFFFF
        return m >> 32


def _running_sum(start: float, terms: np.ndarray) -> float:
    """``start + terms[0] + terms[1] + ...`` one term at a time, as a C loop adds."""
    return float(np.cumsum(np.concatenate(([start], terms)))[-1])


def _tron(X, y, C, eps, max_iter):
    """liblinear's ``TRON::tron`` on ``l2r_l2_svc_fun``: minimizes
    ``w·w / 2 + C Σ max(0, 1 - y x·w)²`` over the CSR rows ``X``; returns
    ``w`` and the iterations. The vector steps are scipy's BLAS calls, the
    library sklearn's liblinear calls, and the products scipy's CSR loops,
    which add a row's terms in liblinear's order."""
    n = X.shape[1]
    state = {}

    def fun(w):
        z = y * (X @ w)
        state["z"] = z
        d = 1 - z
        return _running_sum(_running_sum(0.0, w * w) / 2.0, (C * d * d)[d > 0])

    def grad(w):
        z = state["z"]
        active = np.flatnonzero(z < 1)
        state["C"], state["Xa"] = C[active], X[active]
        return w + 2 * (state["Xa"].T @ (state["C"] * y[active] * (z[active] - 1)))

    def hv(s):
        return s + 2 * (state["Xa"].T @ (state["C"] * (state["Xa"] @ s)))

    def trcg(delta, g):
        s, r = np.zeros(n), -g
        d = r.copy()
        cgtol = 0.1 * blas.dnrm2(g)
        rTr = blas.ddot(r, r)
        while blas.dnrm2(r) > cgtol:
            Hd = hv(d)
            alpha = rTr / blas.ddot(d, Hd)
            s = blas.daxpy(d, s, a=alpha)
            if blas.dnrm2(s) > delta:  # back to the trust region's boundary
                s = blas.daxpy(d, s, a=-alpha)
                std, sts, dtd = blas.ddot(s, d), blas.ddot(s, s), blas.ddot(d, d)
                dsq = delta * delta
                rad = math.sqrt(std * std + dtd * (dsq - sts))
                alpha = (dsq - sts) / (std + rad) if std >= 0 else (rad - std) / dtd
                s = blas.daxpy(d, s, a=alpha)
                r = blas.daxpy(Hd, r, a=-alpha)
                break
            r = blas.daxpy(Hd, r, a=-alpha)
            rnewTrnew = blas.ddot(r, r)
            d = blas.daxpy(r, blas.dscal(rnewTrnew / rTr, d))
            rTr = rnewTrnew
        return s, r

    eta0, eta1, eta2 = 1e-4, 0.25, 0.75
    sigma1, sigma2, sigma3 = 0.25, 0.5, 4.0
    w = np.zeros(n)
    f = fun(w)
    g = grad(w)
    delta = gnorm1 = blas.dnrm2(g)
    search = gnorm1 > eps * gnorm1
    it = 1
    while it <= max_iter and search:
        s, r = trcg(delta, g)
        w_new = blas.daxpy(s, w.copy())
        gs = blas.ddot(g, s)
        prered = -0.5 * (gs - blas.ddot(s, r))
        fnew = fun(w_new)
        actred = f - fnew
        snorm = blas.dnrm2(s)
        if it == 1:
            delta = min(delta, snorm)
        alpha = sigma3 if fnew - f - gs <= 0 else max(sigma1, -0.5 * (gs / (fnew - f - gs)))
        if actred < eta0 * prered:
            delta = min(max(alpha, sigma1) * snorm, sigma2 * delta)
        elif actred < eta1 * prered:
            delta = max(sigma1 * delta, min(alpha * snorm, sigma2 * delta))
        elif actred < eta2 * prered:
            delta = max(sigma1 * delta, min(alpha * snorm, sigma3 * delta))
        else:
            delta = max(delta, min(alpha * snorm, sigma3 * delta))
        if actred > eta0 * prered:
            it += 1
            w, f = w_new, fnew
            g = grad(w)
            if blas.dnrm2(g) <= eps * gnorm1:
                break
        if f < -1.0e32 or (abs(actred) <= 0 and prered <= 0):
            break
        if abs(actred) <= 1.0e-12 * abs(f) and abs(prered) <= 1.0e-12 * abs(f):
            break
    return w, it - 1


def _dual_cd(X, y, C, eps, max_iter, mt):
    """liblinear's ``solve_l2r_l1l2_svc`` for the squared hinge: coordinate
    descent on the dual over the CSR rows ``X``, with shrinking. Returns
    ``w`` and the sweeps."""
    l = X.shape[0]
    rows = [(X.indices[a:b], X.data[a:b]) for a, b in zip(X.indptr[:-1], X.indptr[1:])]
    diag = 0.5 / C
    QD = np.asarray([_running_sum(diag[i], v * v) for i, (_, v) in enumerate(rows)])
    alpha, w = np.zeros(l), np.zeros(X.shape[1])
    index = list(range(l))
    active_size = l
    pg_max_old, pg_min_old = math.inf, -math.inf
    it = 0
    while it < max_iter:
        pg_max_new, pg_min_new = -math.inf, math.inf
        for i in range(active_size):
            j = i + mt.bounded(active_size - i)
            index[i], index[j] = index[j], index[i]
        s = 0
        while s < active_size:
            i = index[s]
            idx, val = rows[i]
            G = _running_sum(0.0, w[idx] * val) * y[i] - 1 + alpha[i] * diag[i]
            PG = 0.0
            if alpha[i] == 0:
                if G > pg_max_old:
                    active_size -= 1
                    index[s], index[active_size] = index[active_size], index[s]
                    continue
                if G < 0:
                    PG = G
            else:
                PG = G
            pg_max_new, pg_min_new = max(pg_max_new, PG), min(pg_min_new, PG)
            if abs(PG) > 1.0e-12:
                old = alpha[i]
                alpha[i] = max(alpha[i] - G / QD[i], 0.0)
                w[idx] += ((alpha[i] - old) * y[i]) * val
            s += 1
        it += 1
        if pg_max_new - pg_min_new <= eps:
            if active_size == l:
                break
            active_size = l
            pg_max_old, pg_min_old = math.inf, -math.inf
            continue
        pg_max_old = math.inf if pg_max_new <= 0 else pg_max_new
        pg_min_old = -math.inf if pg_min_new >= 0 else pg_min_new
    return w, it


def _liblinear_rows(X, perm) -> sparse.csr_matrix:
    """The rows liblinear reads, in the order ``perm``: a sparse row's stored
    entries in their stored order (an unsorted TF-IDF row stays unsorted), a
    dense row's non-zeros by column, each row then the bias feature of value 1."""
    X = sparse.csr_matrix(X)
    rows = [(X.indices[a:b], X.data[a:b]) for a, b in zip(X.indptr[perm], X.indptr[perm + 1])]
    bias_index, one = np.asarray([X.shape[1]], X.indices.dtype), np.ones(1)
    indptr = np.concatenate(([0], np.cumsum([len(i) + 1 for i, _ in rows])))
    indices = np.concatenate([part for i, _ in rows for part in (i, bias_index)])
    data = np.concatenate([part for _, v in rows for part in (v, one)])
    return sparse.csr_matrix((data, indices, indptr), shape=(X.shape[0], X.shape[1] + 1))


class LinearSVC:
    """Squared-hinge linear SVM with an L2 penalty and a penalized bias
    (sklearn's ``LinearSVC`` defaults), one-vs-rest above two classes."""

    def __init__(self, C: float = 1.0, random_state=None):
        self.C, self.random_state = C, random_state

    def fit(self, X, y):
        X = _float_array(X)
        X = X.astype(np.float64) if sparse.issparse(X) else X.astype(np.float64, copy=False)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data, "
                             f"but the data contains only one class: {self.classes_[0]!r}")
        seed = _random_state(self.random_state).randint(INT_MAX)
        self.dual_ = X.shape[0] < X.shape[1]  # dual="auto"
        y_ind = np.searchsorted(self.classes_, y)
        perm = np.argsort(y_ind, kind="stable")  # liblinear groups the rows by class
        y_ind = y_ind[perm]
        Xb = _liblinear_rows(X, perm)
        C = np.full(len(y_ind), float(self.C))
        k = len(self.classes_)
        mt = _MersenneTwister(seed)
        coefs, n_iter = [], []
        for cls in [1] if k == 2 else range(k):
            target = np.where(y_ind == cls, 1.0, -1.0)
            if self.dual_:
                w, it = _dual_cd(Xb, target, C, SVC_TOL, SVC_MAX_ITER, mt)
            else:
                pos = int(np.sum(target > 0))
                eps = SVC_TOL * max(min(pos, len(target) - pos), 1) / len(target)
                w, it = _tron(Xb, target, C, eps, SVC_MAX_ITER)
            coefs.append(w)
            n_iter.append(it)
        raw = np.asarray(coefs)
        self.coef_, self.intercept_ = raw[:, :-1], raw[:, -1].copy()
        self.n_iter_ = max(n_iter)
        if self.n_iter_ >= SVC_MAX_ITER:
            warnings.warn("Liblinear failed to converge, increase the number of iterations.",
                          UserWarning)
        return self

    def decision_function(self, X):
        scores = _float_array(X) @ self.coef_.T + self.intercept_
        return scores.reshape(-1) if scores.shape[1] == 1 else scores

    def predict(self, X):
        scores = self.decision_function(X)
        index = (scores > 0).astype(np.intp) if scores.ndim == 1 else np.argmax(scores, axis=1)
        return self.classes_[index]


# --- pipeline ---------------------------------------------------------------------------


class Pipeline:
    """Transformers then one estimator, fitted in turn (``steps`` as sklearn's)."""

    def __init__(self, steps):
        self.steps = list(steps)

    @property
    def named_steps(self) -> dict:
        return dict(self.steps)

    def _transform(self, X):
        for _, step in self.steps[:-1]:
            X = step.transform(X)
        return X

    def fit(self, X, y):
        for _, step in self.steps[:-1]:
            X = step.fit_transform(X)
        self.steps[-1][1].fit(X, y)
        return self

    def _last(self, name: str):
        method = getattr(self.steps[-1][1], name, None)
        if method is None:
            raise AttributeError(f"'{type(self.steps[-1][1]).__name__}' has no attribute "
                                 f"'{name}'")
        return method

    def predict(self, X):
        return self._last("predict")(self._transform(X))

    def predict_proba(self, X):
        return self._last("predict_proba")(self._transform(X))

    def decision_function(self, X):
        return self._last("decision_function")(self._transform(X))


def standardized(model) -> Pipeline:
    """``StandardScaler`` then ``model``: the JAX package's probe pipelines."""
    return Pipeline([("scaler", StandardScaler()), ("clf", model)])


# --- TF-IDF ------------------------------------------------------------------------------


class TfidfVectorizer:
    """Term counts from a callable analyzer, weighted by smoothed IDF and
    L2-normalized per row (sklearn's defaults otherwise)."""

    def __init__(self, analyzer, use_idf: bool = True):
        if not callable(analyzer):
            raise ValueError("only a callable analyzer is supported")
        self.analyzer, self.use_idf = analyzer, use_idf

    def _counts(self, docs, vocabulary):
        """CSR counts: each row's terms in the order of their column index."""
        fixed = vocabulary is not None
        vocab = vocabulary if fixed else {}
        indices, values, indptr = [], [], [0]
        for doc in docs:
            if isinstance(doc, bytes):
                doc = doc.decode("utf-8")
            counter: dict = {}
            for term in self.analyzer(doc):
                j = vocab.get(term) if fixed else vocab.setdefault(term, len(vocab))
                if j is not None:
                    counter[j] = counter.get(j, 0) + 1
            indices.extend(counter)
            values.extend(counter.values())
            indptr.append(len(indices))
        if not vocab:
            raise ValueError("empty vocabulary; perhaps the documents only contain stop words")
        X = sparse.csr_matrix((np.asarray(values, np.float64), np.asarray(indices, np.int32),
                               np.asarray(indptr, np.int32)),
                              shape=(len(indptr) - 1, len(vocab)))
        X.sort_indices()
        return X, vocab

    def _weigh(self, X):
        if self.use_idf:
            X.data *= self.idf_[X.indices]
        # each row's sum of squares in the order of its stored entries (a sum
        # over axis 0 runs row by row): sklearn's running float64 sum
        lengths = np.diff(X.indptr)
        squares = np.zeros((max(int(lengths.max(initial=0)), 1), X.shape[0]))
        row = np.repeat(np.arange(X.shape[0]), lengths)
        squares[np.arange(len(row)) - X.indptr[row], row] = X.data * X.data
        norms = np.sqrt(squares.sum(axis=0))
        norms[norms == 0.0] = 1.0  # an empty row stays as it is
        X.data /= np.repeat(norms, lengths)
        return X

    def fit_transform(self, raw_documents, y=None):
        if isinstance(raw_documents, str):
            raise ValueError("Iterable over raw text documents expected, string object "
                             "received.")
        X, vocab = self._counts(raw_documents, None)
        # the vocabulary sorted by term; the rows keep their first-seen order
        order = sorted(vocab.items())
        remap = np.empty(len(order), dtype=X.indices.dtype)
        for new, (term, old) in enumerate(order):
            vocab[term] = new
            remap[old] = new
        X.indices = remap.take(X.indices)
        X.has_sorted_indices = False
        self.vocabulary_ = vocab
        if self.use_idf:
            n = X.shape[0] + 1
            df = np.bincount(X.indices, minlength=X.shape[1]).astype(np.float64) + 1.0
            self.idf_ = np.full_like(df, fill_value=n)
            self.idf_ /= df
            np.log(self.idf_, out=self.idf_)
            self.idf_ += 1.0
        return self._weigh(X)

    def fit(self, raw_documents, y=None):
        self.fit_transform(raw_documents)
        return self

    def transform(self, raw_documents):
        if isinstance(raw_documents, str):
            raise ValueError("Iterable over raw text documents expected, string object "
                             "received.")
        return self._weigh(self._counts(raw_documents, self.vocabulary_)[0])


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


def confusion_matrix(y_true, y_pred, labels=None) -> np.ndarray:
    """Counts of (true, predicted) pairs, rows the true labels in ``labels``
    order (the sorted union of both when ``labels`` is None); pairs with a
    label outside ``labels`` are left out."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred) if labels is None else np.asarray(labels)
    index = {label: i for i, label in enumerate(labels.tolist())}
    matrix = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        if t in index and p in index:
            matrix[index[t], index[p]] += 1
    return matrix


__all__ = ["LinearSVC", "LogisticRegression", "Pipeline", "Ridge", "StandardScaler",
           "StratifiedGroupKFold", "StratifiedKFold", "TfidfVectorizer", "confusion_matrix",
           "f1_score", "standardized", "train_test_split"]
