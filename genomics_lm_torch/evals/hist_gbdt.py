"""Histogram gradient boosting, in numpy: the port's stand-in for sklearn's
``HistGradientBoostingClassifier`` at its defaults (what
``benchmark_essentiality_baselines`` fits with ``max_iter=150`` on binary
labels, and ``benchmark_xgboost_dna`` with ``max_iter=200`` on any number of
classes).

It follows sklearn 1.9.0 step by step, so that on the same rows its trees,
and so its predictions, come out as sklearn's:

- bins: per feature, the midpoints of the distinct values where there are
  at most ``MAX_BINS`` of them, otherwise the ``averaged_inverted_cdf``
  percentiles (on a 200,000-row subsample above that many rows); a value
  goes to the number of thresholds below it;
- two classes: the baseline is the log-odds of the mean label, then each
  round fits a tree to the half-binomial gradients and hessians (float32, as
  sklearn keeps them) of the raw scores;
- K > 2 classes (sklearn's multinomial case): the baseline is the symmetric
  multinomial logit of the class priors (each clipped to [eps, 1 - eps],
  their logs less the logs' mean), and each round fits K trees, tree k to
  column k of the softmax gradients ``p - onehot`` and hessians
  ``p (1 - p)``, computed once a round in float64 (the exponentials summed
  class by class) and stored as float32;
- a tree grows best-first by the gain ``G v - G_L v_L - G_R v_R`` with
  ``v = -G / (H + l2 + 1e-15)``, up to ``MAX_LEAF_NODES`` leaves, every
  leaf at least ``MIN_SAMPLES_LEAF`` rows and ``MIN_HESSIAN_TO_SPLIT`` of
  hessian; ties go to the lowest bin, then the lowest feature, and the heap
  of open nodes orders them as sklearn's does;
- histograms are float64 sums in row order, one ``np.bincount`` a node over
  all features (key bin x features + feature); the smaller child is counted and
  the larger one is its parent minus it, as sklearn's grower does;
- a leaf adds ``value x LEARNING_RATE`` to its rows' raw scores (column k
  for class k's tree); two classes: the class is ``raw > 0``, the
  probability ``expit(raw)``; K classes: the probabilities are the softmax
  of the raw scores and the class is their argmax over ``classes_``.

Early stopping is sklearn's ``"auto"``: on above 10,000 rows. sklearn then
draws its validation rows from an unseeded generator, so no run can equal it
there; this one applies the same rule (a tenth of the rows held out by
class, the mean loss as the score, a stop when none of the last
``N_ITER_NO_CHANGE`` rounds beats the round before them by ``TOL``) on rows
drawn from ``random_state``.

Missing values and categorical features are not supported: the callers'
features are finite numbers (codon frequencies, TF-IDF weights).
"""

from __future__ import annotations

import heapq

import numpy as np
from scipy.special import expit, logit
from scipy.stats import gmean

N_BINS = 256  # the histogram width: MAX_BINS non-missing bins and the missing one
SUBSAMPLE = 200_000
# sklearn 1.9.0's defaults, the only values the benchmarks use
LEARNING_RATE = 0.1
MAX_LEAF_NODES = 31
MIN_SAMPLES_LEAF = 20
L2_REGULARIZATION = 0.0
MAX_BINS = 255
MIN_HESSIAN_TO_SPLIT = 1e-3
EARLY_STOPPING_ROWS = 10_000  # "auto": early stopping on above this many rows
VALIDATION_FRACTION = 0.1
N_ITER_NO_CHANGE = 10
TOL = 1e-7


def bin_thresholds(col: np.ndarray, max_bins: int) -> np.ndarray:
    """The binning thresholds of one float64 column (sklearn's
    ``_find_binning_thresholds``)."""
    col = np.sort(col)
    distinct = np.unique(col)
    if len(distinct) == 1:
        return np.asarray([])
    if len(distinct) <= max_bins:
        return (distinct[:-1] + distinct[1:]) / 2  # sliding_window_view(.., 2).mean(axis=1)
    percentiles = np.linspace(0, 100, num=max_bins + 1)[1:-1]
    thresholds = np.percentile(col, percentiles, method="averaged_inverted_cdf")
    unique = np.unique(thresholds)
    if unique.shape[0] != thresholds.shape[0]:
        thresholds = unique
    return np.clip(thresholds, None, np.finfo(np.float64).max)


class _Node:
    """A node of the tree being grown; ``__lt__`` is sklearn's heap order."""

    __slots__ = ("idx", "sum_g", "sum_h", "value", "split", "hist", "left", "right")

    def __init__(self, idx, sum_g, sum_h, value):
        self.idx, self.sum_g, self.sum_h, self.value = idx, sum_g, sum_h, value
        self.split = self.hist = self.left = self.right = None

    def __lt__(self, other):
        return self.split["gain"] > other.split["gain"]


def _node_value(g, h, l2):
    return -g / (h + l2 + 1e-15)


class HistGradientBoostingClassifier:
    """Gradient-boosted trees on binned features: one tree a round for two
    classes, one a class for more."""

    def __init__(self, max_iter: int = 100, random_state=None):
        self.max_iter, self.random_state = max_iter, random_state

    # --- fitting ---------------------------------------------------------------

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)
        if np.isnan(X).any():
            raise ValueError("missing values are not supported")
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError(f"{len(self.classes_)} class: at least two are needed")
        self.n_trees_per_iteration_ = 1 if len(self.classes_) == 2 else len(self.classes_)
        y = np.searchsorted(self.classes_, y).astype(np.float64)
        rng = np.random.RandomState(self.random_state)
        self.do_early_stopping_ = X.shape[0] > EARLY_STOPPING_ROWS
        X_val = y_val = None
        if self.do_early_stopping_:
            val = self._holdout(y, rng)
            X_val, y_val = X[val], y[val]
            keep = np.ones(len(y), bool)
            keep[val] = False
            X, y = X[keep], y[keep]
        fit_rows = X
        if X.shape[0] > SUBSAMPLE:
            fit_rows = X.take(rng.choice(X.shape[0], SUBSAMPLE, replace=True), axis=0)
        self.bin_thresholds_ = [bin_thresholds(fit_rows[:, f], MAX_BINS)
                                for f in range(X.shape[1])]
        binned = self._bin(X)
        n, n_features = binned.shape
        self._binned = binned
        self._keys = binned.astype(np.int64) * n_features + np.arange(n_features)
        self._width = max(len(t) for t in self.bin_thresholds_)  # bins a split may follow

        self.baseline_ = self._baseline(y)
        raw = self._start(n)
        self.trees_ = []
        self.train_score_, self.validation_score_ = [], []
        if self.do_early_stopping_:
            binned_val = self._bin(X_val)
            raw_val = self._start(len(y_val))
            self._score(raw, y, raw_val, y_val)
        for _ in range(self.max_iter):
            if self.n_trees_per_iteration_ == 1:
                grad, hess = self._gradients(y, raw)
                tree, leaves = self._grow(grad, hess)
                self.trees_.append(tree)
                for idx, value in leaves:
                    raw[idx] += value
            else:
                grad, hess = self._softmax_gradients(y, raw)
                self.trees_.append([])
                for k in range(self.n_trees_per_iteration_):
                    tree, leaves = self._grow(grad[:, k], hess[:, k])
                    self.trees_[-1].append(tree)
                    for idx, value in leaves:
                        raw[idx, k] += value
            if self.do_early_stopping_:
                raw_val += self._round_values(self.trees_[-1], binned_val)
                if self._score(raw, y, raw_val, y_val):
                    break
        del self._keys, self._binned
        self.n_iter_ = len(self.trees_)
        return self

    def _baseline(self, y):
        """The intercept-only raw score: the log-odds of the mean label, or the
        symmetric multinomial logit of the class priors (sklearn's
        ``fit_intercept_only``)."""
        if self.n_trees_per_iteration_ == 1:
            eps = 10 * np.finfo(np.float64).eps
            return float(logit(np.clip(np.average(y), eps, 1 - eps)))
        prior = np.zeros(self.n_trees_per_iteration_)
        eps = np.finfo(np.float64).eps
        for k in range(len(prior)):
            prior[k] = np.clip(np.average(y == k), eps, 1 - eps)
        prior = prior[None, :]
        return np.log(prior / gmean(prior, axis=1)[:, None]).reshape(-1)

    def _start(self, n: int) -> np.ndarray:
        if self.n_trees_per_iteration_ == 1:
            return np.full(n, self.baseline_)
        return np.zeros((n, self.n_trees_per_iteration_)) + self.baseline_[None, :]

    def _holdout(self, y, rng) -> np.ndarray:
        """A tenth of each class's rows, drawn from ``rng``."""
        val = []
        for c in range(len(self.classes_)):
            rows = np.flatnonzero(y == c)
            val.append(rng.permutation(rows)[: int(np.ceil(VALIDATION_FRACTION * len(rows)))])
        return np.sort(np.concatenate(val))

    def _score(self, raw, y, raw_val, y_val) -> bool:
        """Append the negative mean losses; True when the last
        ``n_iter_no_change`` rounds beat none of the one before them."""
        for scores, r, t in ((self.train_score_, raw, y),
                             (self.validation_score_, raw_val, y_val)):
            if r.ndim == 1:
                scores.append(-float(np.mean(np.logaddexp(0.0, r) - t * r)))
            else:
                top = r.max(axis=1)
                total = self._class_sum(np.exp(r - top[:, None]))
                loss = np.log(total) + top - r[np.arange(len(t)), t.astype(np.intp)]
                scores.append(-float(np.mean(loss)))
        scores = self.validation_score_
        ref = N_ITER_NO_CHANGE + 1
        if len(scores) < ref:
            return False
        return not any(s > scores[-ref] + TOL for s in scores[-ref + 1:])

    @staticmethod
    def _gradients(y, raw):
        """Half-binomial gradients and hessians, float64 math stored as float32."""
        neg = raw <= -37
        e = np.exp(np.where(neg, raw, -raw))
        grad = np.where(neg, e - y, ((1 - y) - y * e) / (1 + e))
        hess = np.where(neg, e, e / (1 + e) ** 2)
        return grad.astype(np.float32), hess.astype(np.float32)

    @staticmethod
    def _class_sum(p: np.ndarray) -> np.ndarray:
        """Each row's sum over the classes, class by class (sklearn's loop)."""
        total = p[:, 0].copy()
        for k in range(1, p.shape[1]):
            total += p[:, k]
        return total

    @classmethod
    def _softmax_gradients(cls, y, raw):
        """Half-multinomial gradients ``p - onehot`` and hessians ``p (1 - p)``
        of each class, float64 math stored as float32 (n, K)."""
        p = np.exp(raw - raw.max(axis=1)[:, None])
        p /= cls._class_sum(p)[:, None]
        onehot = np.zeros_like(p)
        onehot[np.arange(len(y)), y.astype(np.intp)] = 1.0
        return (p - onehot).astype(np.float32), (p * (1.0 - p)).astype(np.float32)

    def _bin(self, X) -> np.ndarray:
        return np.stack([np.searchsorted(t, X[:, f], side="left")
                         for f, t in enumerate(self.bin_thresholds_)], axis=1).astype(np.uint8)

    def _histograms(self, idx, grad, hess):
        """(count, gradient sum, hessian sum), each (256 bins, n_features),
        summed in row order."""
        F = self._keys.shape[1]
        keys, size, shape = self._keys[idx].ravel(), N_BINS * F, (N_BINS, F)
        return (np.bincount(keys, minlength=size).reshape(shape),
                np.bincount(keys, weights=np.repeat(grad[idx], F), minlength=size).reshape(shape),
                np.bincount(keys, weights=np.repeat(hess[idx], F), minlength=size).reshape(shape))

    def _find_split(self, node):
        """The best split of ``node`` as sklearn's splitter scans it: for each
        feature the lowest bin of highest gain, then the lowest feature of
        highest gain; ``gain`` -1 when no split is allowed."""
        count, hg, hh = node.hist
        n, msl = len(node.idx), MIN_SAMPLES_LEAF
        cn = np.cumsum(count[:self._width], axis=0)
        # msl <= left count <= n - msl, as one unsigned comparison; a feature's
        # last bin holds every row left of it, so it never passes
        flat = np.flatnonzero((cn - msl).view(np.uint64) <= n - 2 * msl)
        if not len(flat):
            return {"gain": -1.0}
        rows = flat[-1] // cn.shape[1] + 1  # the running sums up to the last candidate bin
        gl = np.cumsum(hg[:rows], axis=0).ravel()[flat]
        hl = np.cumsum(hh[:rows], axis=0).ravel()[flat]
        gr, hr = node.sum_g - gl, node.sum_h - hl
        l2, mh = L2_REGULARIZATION, MIN_HESSIAN_TO_SPLIT
        gain = (node.sum_g * node.value - gl * _node_value(gl, hl, l2)) \
            - gr * _node_value(gr, hr, l2)
        gain[(hl < mh) | (hr < mh)] = -np.inf
        i = int(np.argmax(gain))
        if not gain[i] > 0:
            return {"gain": -1.0}
        hit = flat[gain == gain[i]]
        b, f = np.divmod(hit, cn.shape[1])
        j = hit[np.lexsort((b, f))[0]]
        i = int(np.searchsorted(flat, j))
        b, f = divmod(int(j), cn.shape[1])
        return {"gain": float(gain[i]), "feature": f, "bin": b,
                "sum_g": (gl[i], gr[i]), "sum_h": (hl[i], hr[i]),
                "value": (_node_value(gl[i], hl[i], l2), _node_value(gr[i], hr[i], l2))}

    def _grow(self, grad, hess):
        """One tree: best-first splits as sklearn's ``TreeGrower``. Returns the
        tree (nested dicts) and each leaf's (rows, shrunk value)."""
        idx = np.arange(self._keys.shape[0])
        leaves, open_nodes = [], []

        def push(node):
            node.split = self._find_split(node)
            if node.split["gain"] <= 0:
                leaves.append(node)
            else:
                heapq.heappush(open_nodes, node)

        hist = self._histograms(idx, grad, hess)
        root = _Node(idx, np.ascontiguousarray(hist[1][:, 0]).sum(),
                     np.ascontiguousarray(hist[2][:, 0]).sum(), 0.0)
        if len(idx) >= 2 * MIN_SAMPLES_LEAF and root.sum_h >= MIN_HESSIAN_TO_SPLIT:
            root.hist = hist
            push(root)
        else:
            leaves.append(root)
        while open_nodes:
            node = heapq.heappop(open_nodes)
            s = node.split
            goes_left = self._binned[node.idx, s["feature"]] <= s["bin"]
            children = [_Node(node.idx[side], s["sum_g"][i], s["sum_h"][i], s["value"][i])
                        for i, side in enumerate((goes_left, ~goes_left))]
            node.left, node.right = children
            if len(leaves) + len(open_nodes) + 2 == MAX_LEAF_NODES:
                leaves.extend(children)
                leaves.extend(open_nodes)
                open_nodes.clear()
                continue
            split_me = [len(c.idx) >= 2 * MIN_SAMPLES_LEAF for c in children]
            for c, ok in zip(children, split_me):
                if not ok:
                    leaves.append(c)
            if any(split_me):
                small, large = ((children[0], children[1])
                                if len(children[0].idx) < len(children[1].idx)
                                else (children[1], children[0]))
                small.hist = self._histograms(small.idx, grad, hess)
                large.hist = tuple(p - q for p, q in zip(node.hist, small.hist))
                for c, ok in zip(children, split_me):
                    if ok:
                        push(c)
            node.hist = None
            for c in children:
                c.hist = None if c in leaves else c.hist
        rows = []
        for leaf in leaves:
            leaf.value = leaf.value * LEARNING_RATE
            rows.append((leaf.idx, leaf.value))
        return self._freeze(root), rows

    @staticmethod
    def _freeze(node) -> dict:
        if node.left is None:
            return {"value": node.value}
        return {"feature": node.split["feature"], "bin": node.split["bin"],
                "left": HistGradientBoostingClassifier._freeze(node.left),
                "right": HistGradientBoostingClassifier._freeze(node.right)}

    @staticmethod
    def _tree_values(tree: dict, binned: np.ndarray) -> np.ndarray:
        out = np.empty(binned.shape[0])
        stack = [(tree, np.arange(binned.shape[0]))]
        while stack:
            node, rows = stack.pop()
            if "value" in node:
                out[rows] = node["value"]
                continue
            left = binned[rows, node["feature"]] <= node["bin"]
            stack += [(node["left"], rows[left]), (node["right"], rows[~left])]
        return out

    def _round_values(self, trees, binned: np.ndarray) -> np.ndarray:
        """One round's leaf values: (n,) for one tree, (n, K) for K."""
        if self.n_trees_per_iteration_ == 1:
            return self._tree_values(trees, binned)
        return np.stack([self._tree_values(t, binned) for t in trees], axis=1)

    # --- prediction ----------------------------------------------------------------

    def decision_function(self, X) -> np.ndarray:
        """The raw score: the baseline plus each round's leaf values, in order;
        (n,) for two classes, (n, K) for K."""
        binned = self._bin(np.asarray(X, dtype=np.float64))
        raw = self._start(binned.shape[0])
        for trees in self.trees_:
            raw += self._round_values(trees, binned)
        return raw

    def predict(self, X) -> np.ndarray:
        raw = self.decision_function(X)
        index = (raw > 0).astype(np.intp) if raw.ndim == 1 else np.argmax(raw, axis=1)
        return self.classes_[index]

    def predict_proba(self, X) -> np.ndarray:
        raw = self.decision_function(X)
        if raw.ndim == 1:
            p = expit(raw)
            return np.stack([1 - p, p], axis=1)
        raw -= raw.max(axis=1).reshape(-1, 1)  # sklearn's softmax
        np.exp(raw, out=raw)
        raw /= raw.sum(axis=1).reshape(-1, 1)
        return raw


__all__ = ["HistGradientBoostingClassifier", "bin_thresholds"]
