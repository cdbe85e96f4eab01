"""The port's PCA, KMeans and HDBSCAN, in numpy and scipy: what
``evals/motifs.py::MotifClusterer`` fits, at the settings it uses, so motif
mining runs on a machine without sklearn.

Each follows sklearn 1.9.0's source step by step, dtype by dtype:

- ``PCA(n_components, random_state)``: sklearn's ``svd_solver="auto"``
  choice (``covariance_eigh`` for at most 1,000 features and ten times as
  many rows, ``full`` up to 500 rows and columns, ``randomized`` for fewer
  components than 80% of the smaller side, ``full`` otherwise); the mean
  removed; ``covariance_eigh`` as ``numpy.linalg.eigh`` of
  ``(XᵀX - n μμᵀ) / (n - 1)``, ``full`` as scipy's ``gesdd``, ``randomized``
  as sklearn's range finder (10 oversamples, 7 power iterations below a
  tenth of the smaller side and 4 above, LU-normalized, a final QR, the
  Gaussian draw from ``RandomState(random_state)``); ``svd_flip``'s sign
  rule on the components' rows; ``fit_transform`` is ``U S`` where the
  solver gives ``U``, else the projection of the centred rows.
- ``KMeans(n_clusters, random_state)``, as sklearn's ``n_init="auto"``: one
  greedy k-means++ run (``2 + int(log k)`` local trials, the draws from
  ``RandomState(random_state)`` in sklearn's order, the candidate distances
  in float64 batches as ``_euclidean_distances_upcast`` sizes them) on the
  data centred on its mean; then Lloyd's iterations up to ``max_iter`` 300:
  labels from ``‖c‖² - 2 x·c`` by one BLAS ``gemm`` a 256-row chunk (scipy's
  BLAS, which sklearn's Cython calls), the first of tied minima; centres as
  sums in row order in the input's dtype times ``1 / count``; empty clusters
  relocated to the rows farthest from their centres; a strict stop when the
  labels repeat, else a stop once the squared centre shift is at most
  ``tol`` 1e-4 times the mean feature variance, then a final E-step. The
  sums follow sklearn's one-thread order: with more OpenMP threads sklearn
  adds per-thread partial sums, which can differ from these in the last
  bit.
- ``HDBSCAN(min_cluster_size)`` at sklearn's defaults: ``min_samples``
  equal to ``min_cluster_size``, counting the point itself; float64
  Euclidean distances summed feature by feature, as sklearn's
  ``DistanceMetric`` sums them; core distances the ``min_samples``-th
  nearest; Prim's MST on the mutual reachability started at row 0
  (``mst_from_data_matrix``, ties to the lowest row), its edges ordered by
  sklearn's own ``np.argsort`` call; the single-linkage tree, the condensed
  tree, the stabilities and ``"eom"`` selection without a single cluster;
  label -1 for noise. Where sklearn finds the core distances with a KD-tree
  this computes them a block of rows at a time (``CORE_CHUNK_ELEMENTS``
  distances a block, each row's ``min_samples``-th nearest kept), and
  Prim's algorithm computes each row of distances from X when it adds that
  row, as ``mst_from_data_matrix`` does: O(n² d) time, as sklearn's MST,
  and O(n · chunk + n · d) memory, never an n x n matrix.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import linalg
from scipy.linalg import blas
from scipy.spatial.distance import cdist

from genomics_lm_torch.evals.estimators import _float_array, _random_state

CHUNK_SIZE = 256  # sklearn's rows a Lloyd chunk
CORE_CHUNK_ELEMENTS = 1 << 19  # distances a block of HDBSCAN's core-distance pass


def row_norms(X) -> np.ndarray:
    """Squared row norms, sklearn's ``einsum``."""
    return np.einsum("ij,ij->i", X, X)


def svd_flip_rows(v: np.ndarray, u: np.ndarray | None = None):
    """sklearn's ``svd_flip(u, v, u_based_decision=False)``: each row of ``v``
    signed so that its largest absolute entry is positive."""
    rows = np.arange(v.shape[0])
    signs = np.sign(v[rows, np.argmax(np.abs(v), axis=1)])
    if u is not None:
        u *= signs[np.newaxis, :]
    v *= signs[:, np.newaxis]
    return u, v


# --- PCA ----------------------------------------------------------------------------


class PCA:
    """Principal components by sklearn's ``auto`` solver choice."""

    N_OVERSAMPLES = 10

    def __init__(self, n_components: int, random_state=None):
        self.n_components, self.random_state = int(n_components), random_state

    def _solver(self, X) -> str:
        n, d = X.shape
        if d <= 1_000 and n >= 10 * d:
            return "covariance_eigh"
        if max(X.shape) <= 500:
            return "full"
        if 1 <= self.n_components < 0.8 * min(X.shape):
            return "randomized"
        return "full"

    def fit_transform(self, X):
        X = _float_array(X)
        n, d = X.shape
        k = self.n_components
        if not 1 <= k <= min(n, d):
            raise ValueError(f"n_components={k} must be between 1 and "
                             f"min(n_samples, n_features)={min(n, d)}")
        self.svd_solver_ = self._solver(X)
        self.mean_ = np.mean(X, axis=0)
        U = None
        if self.svd_solver_ == "covariance_eigh":
            C = X.T @ X
            C -= n * self.mean_.reshape(-1, 1) * self.mean_.reshape(1, -1)
            C /= n - 1
            eigenvals, eigenvecs = np.linalg.eigh(C)
            eigenvals, eigenvecs = np.flip(eigenvals, axis=0), np.flip(eigenvecs, axis=1)
            eigenvals[eigenvals < 0.0] = 0.0
            S, Vt = np.sqrt(eigenvals * (n - 1)), eigenvecs.T
            svd_flip_rows(Vt)
        else:
            centred = X - self.mean_
            if self.svd_solver_ == "full":
                U, S, Vt = linalg.svd(centred, full_matrices=False)
            else:
                U, S, Vt = self._randomized_svd(centred)
            U, Vt = svd_flip_rows(Vt, U)
        self.components_ = np.array(Vt[:k], copy=True)
        self.explained_variance_ = np.array((S**2 / (n - 1))[:k], copy=True)
        self.singular_values_ = np.array(S[:k], copy=True)
        self.n_components_ = k
        if U is not None:
            U = U[:, :k]
            U *= S[:k]
            return U
        return self.transform(X)

    def _randomized_svd(self, M):
        """sklearn's ``_randomized_svd(..., flip_sign=False)`` on the centred rows."""
        rng = _random_state(self.random_state)
        k = self.n_components
        size = k + self.N_OVERSAMPLES
        n_iter = 7 if k < 0.1 * min(M.shape) else 4
        transpose = M.shape[0] < M.shape[1]
        if transpose:
            M = M.T
        Q = rng.normal(size=(M.shape[1], size))
        if M.dtype == np.float32:
            Q = Q.astype(np.float32, copy=False)
        for _ in range(n_iter):  # n_iter > 2 always, so sklearn's "auto" normalizer is LU
            Q, _ = linalg.lu(M @ Q, permute_l=True, check_finite=False)
            Q, _ = linalg.lu(M.T @ Q, permute_l=True, check_finite=False)
        Q, _ = linalg.qr(M @ Q, mode="economic", check_finite=False)
        Uhat, s, Vt = linalg.svd(Q.T @ M, full_matrices=False, lapack_driver="gesdd")
        U = Q @ Uhat
        if transpose:
            return Vt[:k, :].T, s[:k], U[:, :k].T
        return U[:, :k], s[:k], Vt[:k, :]

    def fit(self, X, y=None):
        self.fit_transform(X)
        return self

    def transform(self, X):
        out = _float_array(X) @ self.components_.T
        out -= self.mean_.reshape(1, -1) @ self.components_.T
        return out


# --- KMeans ---------------------------------------------------------------------------


def _gen_batches(n: int, size: int):
    for start in range(0, n, size):
        yield slice(start, min(start + size, n))


def _sq_distances_upcast(X, Y) -> np.ndarray:
    """sklearn's ``_euclidean_distances_upcast`` for float32 ``X`` and ``Y``
    with no norms given: float64 products batch by batch, stored as float32,
    then clipped at 0."""
    nx, ny, d = X.shape[0], Y.shape[0], X.shape[1]
    distances = np.empty((nx, ny), dtype=np.float32)
    maxmem = max(((nx + ny) * d + nx * ny) / 10, 10 * 2**17)
    tmp = 2 * d
    batch = max(int((-tmp + math.sqrt(tmp**2 + 4 * maxmem)) / 2), 1)
    for xs in _gen_batches(nx, batch):
        X_chunk = X[xs, :].astype(np.float64)
        XX = row_norms(X_chunk)[:, None]
        for ys in _gen_batches(ny, batch):
            Y_chunk = Y[ys, :].astype(np.float64)
            d_ = -2 * (X_chunk @ Y_chunk.T)
            d_ += XX
            d_ += row_norms(Y_chunk)[None, :]
            distances[xs, ys] = d_.astype(np.float32, copy=False)
    np.maximum(distances, 0, out=distances)
    return distances


def _sq_distances(X, Y, Y_norm_squared) -> np.ndarray:
    """sklearn's squared ``_euclidean_distances(X, Y, Y_norm_squared=...)``."""
    if X.dtype == np.float32:
        return _sq_distances_upcast(X, Y)
    d_ = -2 * (X @ Y.T)
    d_ += row_norms(X)[:, None]
    d_ += Y_norm_squared.reshape(1, -1)
    np.maximum(d_, 0, out=d_)
    return d_


def kmeans_plusplus(X, n_clusters: int, x_squared_norms, sample_weight, rng):
    """Greedy k-means++ (sklearn's ``_kmeans_plusplus``): the centres' rows."""
    n_samples = X.shape[0]
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = rng.choice(n_samples, p=sample_weight / sample_weight.sum())
    indices = np.full(n_clusters, -1, dtype=int)
    centers[0] = X[center_id]
    indices[0] = center_id
    closest_dist_sq = _sq_distances(centers[0, np.newaxis], X, x_squared_norms)
    current_pot = closest_dist_sq @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = rng.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1, out=candidate_ids)
        distance_to_candidates = _sq_distances(X[candidate_ids], X, x_squared_norms)
        np.minimum(closest_dist_sq, distance_to_candidates, out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ sample_weight.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest_dist_sq = distance_to_candidates[best]
        centers[c] = X[candidate_ids[best]]
        indices[c] = candidate_ids[best]
    return centers, indices


def _dense_sq_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise ``‖a - b‖²`` in the inputs' dtype, four features a step as
    sklearn's ``_euclidean_dense_dense`` sums them."""
    diff = a - b
    sq = diff * diff
    n_features = a.shape[1]
    out = np.zeros(a.shape[0], dtype=a.dtype)
    for i in range(0, n_features - n_features % 4, 4):
        out += ((sq[:, i] + sq[:, i + 1]) + sq[:, i + 2]) + sq[:, i + 3]
    for i in range(n_features - n_features % 4, n_features):
        out += sq[:, i]
    return out


def _labels(X, centers) -> np.ndarray:
    """The E-step: each row's nearest centre by ``‖c‖² - 2 x·c``, one gemm a
    256-row chunk as sklearn's ``_update_chunk_dense`` calls it."""
    n = X.shape[0]
    gemm = blas.sgemm if X.dtype == np.float32 else blas.dgemm
    pairwise = np.empty((n, centers.shape[0]), dtype=X.dtype)
    pairwise[:] = row_norms(centers)
    chunk = min(CHUNK_SIZE, n)
    for start in range(0, n, chunk):
        rows = slice(start, min(start + chunk, n))
        gemm(-2.0, centers.T, X[rows].T, beta=1.0, c=pairwise[rows].T, trans_a=1,
             overwrite_c=1)
    return np.argmin(pairwise, axis=1).astype(np.int32)


def _lloyd_step(X, centers_old, labels):
    """The M-step after ``labels``: centres as sums in row order times
    ``1 / count`` in the data's dtype, empty clusters relocated (sklearn's
    ``_relocate_empty_clusters_dense``); returns the centres and each one's
    shift."""
    n_clusters, dtype = centers_old.shape[0], X.dtype
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(n_clusters + 1))
    centers = np.zeros_like(centers_old)
    for j in range(n_clusters):
        if bounds[j + 1] > bounds[j]:
            centers[j] = X[order[bounds[j]:bounds[j + 1]]].sum(axis=0)
    weight = np.diff(bounds).astype(dtype)
    empty = np.where(np.equal(weight, 0))[0].astype(np.int32)
    if len(empty):
        distances = ((X - centers_old[labels]) ** 2).sum(axis=1)
        far = np.argpartition(distances, -len(empty))[:-len(empty) - 1:-1].astype(np.int32)
        if np.max(distances) != 0:
            for new_id, far_idx in zip(empty, far):
                old_id = labels[far_idx]
                centers[old_id] -= X[far_idx]
                centers[new_id] = X[far_idx]
                weight[new_id] = 1
                weight[old_id] -= 1
    heaviest = np.argmax(weight)
    for j in range(n_clusters):
        if weight[j] > 0:
            centers[j] *= dtype.type(1.0 / np.float64(weight[j]))
        else:
            centers[j] = centers[heaviest]
    shift = np.sqrt(_dense_sq_dist(centers, centers_old))
    return centers, shift


class KMeans:
    """Lloyd's k-means from one k-means++ start (sklearn's ``n_init="auto"``)."""

    MAX_ITER = 300
    TOL = 1e-4

    def __init__(self, n_clusters: int = 8, random_state=None):
        self.n_clusters, self.random_state = int(n_clusters), random_state

    def fit(self, X, y=None):
        X = _float_array(X).copy()  # centred in place below
        if X.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={X.shape[0]} should be >= "
                             f"n_clusters={self.n_clusters}.")
        tol = np.mean(np.var(X, axis=0)) * self.TOL
        rng = _random_state(self.random_state)
        sample_weight = np.ones(X.shape[0], dtype=X.dtype)
        X_mean = X.mean(axis=0)
        X -= X_mean
        centers, _ = kmeans_plusplus(X, self.n_clusters, row_norms(X), sample_weight, rng)
        self.init_inertia_ = self._inertia(X, centers, _labels(X, centers))
        labels_old = np.full(X.shape[0], -1, dtype=np.int32)
        strict = False
        for i in range(self.MAX_ITER):
            labels = _labels(X, centers)
            centers, shift = _lloyd_step(X, centers, labels)
            if np.array_equal(labels, labels_old):
                strict = True
                break
            if (shift**2).sum() <= tol:
                break
            labels_old = labels
        if not strict:
            labels = _labels(X, centers)
        self.inertia_ = self._inertia(X, centers, labels)
        centers += X_mean
        self.cluster_centers_, self.labels_, self.n_iter_ = centers, labels, i + 1
        return self

    @staticmethod
    def _inertia(X, centers, labels) -> float:
        """Σ ‖x - c‖² in the data's dtype, summed in row order (one thread)."""
        return float(np.cumsum(_dense_sq_dist(X, centers[labels]))[-1])

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_

    def predict(self, X):
        X = _float_array(X)
        return _labels(X, self.cluster_centers_.astype(X.dtype))


# --- HDBSCAN ----------------------------------------------------------------------------


def _distance_rows(X: np.ndarray, rows: slice) -> np.ndarray:
    """float64 Euclidean distances of ``X[rows]`` to every row. scipy's
    ``cdist`` adds the squared differences feature by feature, in order, as
    sklearn's ``DistanceMetric`` does."""
    sq = cdist(X[rows], X, "sqeuclidean")
    return np.sqrt(sq, out=sq)


def _core_distances(X: np.ndarray, min_samples: int) -> np.ndarray:
    """Each row's ``min_samples``-th nearest distance (itself included), from
    blocks of at most ``CORE_CHUNK_ELEMENTS`` distances."""
    n = X.shape[0]
    step = max(1, CORE_CHUNK_ELEMENTS // n)
    core = np.empty(n)
    for lo in range(0, n, step):
        block = _distance_rows(X, slice(lo, min(lo + step, n)))
        block.partition(min_samples - 1, axis=1)
        core[lo:lo + len(block)] = block[:, min_samples - 1]
    return core


def _prim_mst(X: np.ndarray, core: np.ndarray) -> np.ndarray:
    """sklearn's ``mst_from_data_matrix``: (source, target, distance) rows in
    the order Prim's algorithm adds them, from row 0; the row of distances
    from each added point is computed from X as it is added."""
    n = X.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    min_reach = np.full(n, np.inf)
    sources = np.ones(n, dtype=np.int64)
    edges = np.empty((n - 1, 3))
    current = 0
    for i in range(n - 1):
        in_tree[current] = True
        row = _distance_rows(X, slice(current, current + 1))[0]
        mrd = np.maximum(np.maximum(core[current], core), row)
        closer = (mrd < min_reach) & ~in_tree
        min_reach[closer] = mrd[closer]
        sources[closer] = current
        candidates = np.where(in_tree, np.inf, min_reach)
        new = int(np.argmin(candidates))
        edges[i] = (sources[new], new, candidates[new])
        current = new
    return edges


def _single_linkage(edges: np.ndarray) -> np.ndarray:
    """(left, right, distance, size) rows as sklearn's ``make_single_linkage``
    builds them with its union-find."""
    n = len(edges) + 1
    parent = np.full(2 * n - 1, -1, dtype=np.int64)
    size = np.concatenate([np.ones(n, dtype=np.int64), np.zeros(n - 1, dtype=np.int64)])

    def find(x):
        root = x
        while parent[root] != -1:
            root = parent[root]
        while parent[x] != -1 and parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    out = []
    for i, (a, b, dist) in enumerate(edges):
        ra, rb = find(int(a)), find(int(b))
        out.append((ra, rb, dist, size[ra] + size[rb]))
        parent[ra] = parent[rb] = n + i
        size[n + i] = size[ra] + size[rb]
    return out


def _bfs(hierarchy, root: int, n: int) -> list[int]:
    queue, result = [root], []
    while queue:
        result.extend(queue)
        queue = [x - n for x in queue if x >= n]
        queue = [c for node in queue for c in hierarchy[node][:2]]
    return result


def _condense_tree(hierarchy, min_cluster_size: int) -> list[tuple]:
    """sklearn's ``_condense_tree``: (parent, child, lambda, size) rows."""
    n = len(hierarchy) + 1
    root = 2 * len(hierarchy)
    next_label = n + 1
    relabel = np.empty(root + 1, dtype=np.int64)
    relabel[root] = n
    ignore = np.zeros(root + 1, dtype=bool)
    rows = []

    def drop(node, parent_label, lam):
        for sub in _bfs(hierarchy, node, n):
            if sub < n:
                rows.append((parent_label, sub, lam, 1))
            ignore[sub] = True

    for node in _bfs(hierarchy, root, n):
        if ignore[node] or node < n:
            continue
        left, right, distance, _ = hierarchy[node - n]
        lam = 1.0 / distance if distance > 0.0 else np.inf
        left_count = hierarchy[left - n][3] if left >= n else 1
        right_count = hierarchy[right - n][3] if right >= n else 1
        here = relabel[node]
        if left_count >= min_cluster_size and right_count >= min_cluster_size:
            relabel[left] = next_label
            rows.append((here, next_label, lam, left_count))
            relabel[right] = next_label + 1
            rows.append((here, next_label + 1, lam, right_count))
            next_label += 2
        elif left_count < min_cluster_size and right_count < min_cluster_size:
            drop(left, here, lam)
            drop(right, here, lam)
        elif left_count < min_cluster_size:
            relabel[right] = here
            drop(left, here, lam)
        else:
            relabel[left] = here
            drop(right, here, lam)
    return rows


def _eom_labels(condensed: list[tuple]) -> np.ndarray:
    """Stabilities, ``"eom"`` selection without a single cluster, and each
    point's label (sklearn's ``_compute_stability``, ``_get_clusters`` and
    ``_do_labelling``)."""
    parent = np.asarray([r[0] for r in condensed], dtype=np.int64)
    child = np.asarray([r[1] for r in condensed], dtype=np.int64)
    lam = np.asarray([r[2] for r in condensed], dtype=np.float64)
    size = np.asarray([r[3] for r in condensed], dtype=np.int64)
    smallest = int(parent.min())
    births = np.full(max(int(child.max()), smallest) + 1, np.nan)
    births[child] = lam
    births[smallest] = 0.0
    result = np.zeros(int(parent.max()) - smallest + 1)
    for p, value, count in zip(parent, lam, size):
        result[p - smallest] += (value - births[p]) * count
    stability = {idx + smallest: result[idx] for idx in range(len(result))}

    nodes = sorted(stability, reverse=True)[:-1]
    tree = size > 1
    tree_parent, tree_child = parent[tree], child[tree]
    is_cluster = {c: True for c in nodes}
    for node in nodes:
        subtree = np.sum([stability[c] for c in tree_child[tree_parent == node]])
        if subtree > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            queue = np.array([node])
            while len(queue):
                for sub in queue.tolist():
                    if sub != node:
                        is_cluster[sub] = False
                queue = tree_child[np.isin(tree_parent, queue)]
    clusters = {c for c in is_cluster if is_cluster[c]}
    label_of = {c: i for i, c in enumerate(sorted(clusters))}

    # _do_labelling: a union-find joining every edge below an unselected cluster
    uf_parent = np.arange(int(parent.max()) + 1)
    uf_rank = np.zeros_like(uf_parent)

    def find(x):
        root = x
        while uf_parent[root] != root:
            root = uf_parent[root]
        while uf_parent[x] != root:
            uf_parent[x], x = root, uf_parent[x]
        return root

    for c, p in zip(child, parent):
        if c in clusters:
            continue
        rx, ry = find(p), find(c)
        if uf_rank[rx] < uf_rank[ry]:
            uf_parent[rx] = ry
        elif uf_rank[rx] > uf_rank[ry]:
            uf_parent[ry] = rx
        else:
            uf_parent[ry] = rx
            uf_rank[rx] += 1
    labels = np.empty(smallest, dtype=np.intp)
    for point in range(smallest):
        cluster = find(point)
        labels[point] = -1 if cluster == smallest else label_of[cluster]
    return labels


class HDBSCAN:
    """Density clustering over the mutual-reachability MST."""

    def __init__(self, min_cluster_size: int = 5):
        self.min_cluster_size = int(min_cluster_size)

    def fit(self, X, y=None):
        X = np.array(X, dtype=np.float64, order="C")
        if X.shape[0] == 1:
            raise ValueError("n_samples=1 while HDBSCAN requires more than one sample")
        min_samples = self.min_cluster_size
        if min_samples > X.shape[0]:
            raise ValueError(f"min_samples ({min_samples}) must be at most the number of "
                             f"samples in X ({X.shape[0]})")
        core = _core_distances(X, min_samples)
        edges = _prim_mst(X, core)
        edges = edges[np.argsort(edges[:, 2])]
        hierarchy = _single_linkage(edges)
        self.labels_ = _eom_labels(_condense_tree(hierarchy, self.min_cluster_size))
        return self

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_


__all__ = ["HDBSCAN", "KMeans", "PCA", "kmeans_plusplus", "row_norms", "svd_flip_rows"]
