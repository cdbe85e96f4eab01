"""The port's downstream classifiers and motif clustering against sklearn
1.9.0, the release the JAX package's probes run against, and against the JAX
package's functions and scripts, on the same numpy inputs drawn from seeds.

- ``LinearSVC`` (``evals/estimators.py``): binary and three classes, on the
  primal path (rows >= features: liblinear's trust-region Newton) and the
  dual path (fewer rows: coordinate descent); calls equal, decisions within
  ``PRIMAL_ATOL`` and the dual's stopping-rule bound (``dual_bound``), and,
  seeded alike, liblinear's own sweep order.
- ``TfidfVectorizer``: k 3 and 5, ``use_idf`` on and off: the vocabulary
  equal, the matrices within ``TFIDF_ATOL``.
- ``fit_logreg``, ``fit_linear_svm``, ``fit_kmer_logreg`` and
  ``fit_kmer_svm`` against the JAX package's (sklearn's) fits: calls equal,
  probabilities and decisions within ``PROBA_ATOL``, metrics within
  ``METRIC_TOL``.
- The multiclass booster (``evals/hist_gbdt.py``) against sklearn's
  ``HistGradientBoostingClassifier``: calls equal, probabilities within
  ``PROBA_ATOL``; the binary booster's raw scores unchanged bit for bit.
- ``PCA``, ``KMeans`` and ``HDBSCAN`` (``evals/clustering.py``): PCA on its
  three solver branches (components and transforms within ``PCA_ATOL``,
  the same signs), KMeans (labels and ``n_iter_`` equal, inertia within
  ``INERTIA_RTOL``; an empty cluster's relocation equal to sklearn's Lloyd
  step), HDBSCAN on blobs with noise (labels equal, noise included).
- ``benchmark_xgboost_dna`` and ``probe_ss_linear`` against
  ``scripts/benchmark_xgboost_dna.py`` and ``scripts/probe_ss_linear.py``:
  reports equal, but for the booster's ``engine`` name.

sklearn runs under ``threadpool_limits(1)``: its booster's OpenMP loops
beside the suite's other workers slow every process, and KMeans adds
per-thread partial sums that one thread (the port's order) does not.
"""

from __future__ import annotations

import functools
import hashlib
import json
import pickle
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
from sklearn.cluster import HDBSCAN as SkHDBSCAN
from sklearn.cluster import KMeans as SkKMeans
from sklearn.cluster._k_means_lloyd import lloyd_iter_chunked_dense
from sklearn.decomposition import PCA as SkPCA
from sklearn.ensemble import HistGradientBoostingClassifier as SkGBDT
from sklearn.feature_extraction.text import TfidfVectorizer as SkTfidf
from sklearn.metrics import confusion_matrix as sk_confusion
from sklearn.svm import LinearSVC as SkSVC
from threadpoolctl import threadpool_limits

from genomics_lm_tpu.evals import metrics as jax_metrics
from genomics_lm_tpu.evals import probes as jax_probes
from genomics_lm_torch.evals import clustering, estimators, metrics, probes
from genomics_lm_torch.evals.hist_gbdt import HistGradientBoostingClassifier

# The port runs liblinear's steps with the BLAS library sklearn's liblinear
# calls (scipy's) and adds each row's terms in liblinear's order: bit-equal
# here; 1e-6 leaves room for another BLAS build and stays far below a
# decision that moves a call.
PRIMAL_ATOL = 1e-6
# The float operations of sklearn's TF-IDF in its order: bit-equal here; the
# bound leaves a libm's log one ulp apart.
TFIDF_ATOL = 1e-15
PROBA_ATOL = 1e-6  # the L-BFGS-B, liblinear and booster fits: rounding carried through iterates
METRIC_TOL = 1e-12  # rank metrics of equal calls and scores equal to rounding
PCA_ATOL = 1e-6  # relative to the largest entry; the same LAPACK calls on the same float32 data
INERTIA_RTOL = 1e-6  # float32 sums of squares: sklearn's threads add partial sums


@pytest.fixture(scope="module", autouse=True)
def _one_native_thread():
    with threadpool_limits(limits=1):
        yield


def dual_bound(X, C: float = 1.0, eps: float = estimators.SVC_TOL) -> float:
    """How far two fits stopped by liblinear's dual rule may decide apart.

    liblinear stops once every projected gradient of a sweep lies within
    ``eps`` of the others, which spans 0, so ``|PG_i| <= eps``. The dual of the
    squared hinge is strongly convex with modulus ``1 / (2C)``, so the
    multipliers lie within ``2 C sqrt(n) eps`` of the optimum; ``w`` is
    ``X~^T (y α)``, within ``||X~||_2`` times that; a decision moves by at
    most ``max ||x~||`` times ``w``'s error; two such fits, twice that."""
    Xb = np.hstack([X, np.ones((X.shape[0], 1))])
    alpha_err = 2 * C * np.sqrt(Xb.shape[0]) * eps
    return 2 * float(np.linalg.norm(Xb, axis=1).max()) * float(np.linalg.norm(Xb, 2)) * alpha_err


def linear_data(seed, n, d, k):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.argmax(X @ rng.normal(size=(d, k)) + rng.normal(size=(n, k)), axis=1)
    return X, y


SVC_CASES = {"binary_primal": (200, 30, 2), "three_class_primal": (300, 40, 3),
             "binary_dual": (40, 100, 2), "three_class_dual": (50, 120, 3)}


@pytest.mark.parametrize("case", sorted(SVC_CASES))
def test_linear_svc_is_liblinear_s(case):
    n, d, k = SVC_CASES[case]
    X, y = linear_data(len(case), n, d, k)
    X_new, _ = linear_data(99, 30, d, k)
    want = SkSVC(random_state=3).fit(X, y)
    got = estimators.LinearSVC(random_state=3).fit(X, y)
    assert got.dual_ == case.endswith("dual") and got.coef_.shape == want.coef_.shape
    for rows in (X, X_new):
        np.testing.assert_array_equal(got.predict(rows), want.predict(rows))
        err = np.abs(got.decision_function(rows) - want.decision_function(rows)).max()
        if got.dual_:
            assert err <= dual_bound(X), (err, dual_bound(X))
        # seeded alike, the dual walks liblinear's sweeps in liblinear's order
        assert err <= PRIMAL_ATOL, err
    assert got.n_iter_ == want.n_iter_


TFIDF_CASES = [(3, True), (3, False), (5, True), (5, False)]


def random_dna(seed, n, lo=30, hi=240):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))) for _ in range(n)]


@pytest.mark.parametrize("k,use_idf", TFIDF_CASES, ids=[f"k{k}-{'idf' if i else 'tf'}"
                                                        for k, i in TFIDF_CASES])
def test_tfidf_is_sklearn_s(k, use_idf):
    seqs = random_dna(k, 50) + ["ACG", "acgu" * 9]
    kw = dict(analyzer=probes._KmerAnalyzer(k), use_idf=use_idf)
    want_vec = SkTfidf(lowercase=False, norm="l2", **kw)
    got_vec = estimators.TfidfVectorizer(**kw)
    want, got = want_vec.fit_transform(seqs[:40]), got_vec.fit_transform(seqs[:40])
    assert got_vec.vocabulary_ == want_vec.vocabulary_
    for g, w in ((got, want), (got_vec.transform(seqs[40:]), want_vec.transform(seqs[40:]))):
        assert sp.isspmatrix_csr(g) and g.dtype == np.float64 and g.shape == w.shape
        assert abs(g - w).max() <= TFIDF_ATOL
        np.testing.assert_array_equal(g.indptr, w.indptr)


def assert_same_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert abs(got[key] - value) <= METRIC_TOL or (np.isnan(value) and np.isnan(got[key]))


def three_class_dna(seed, n):
    seqs = random_dna(seed, n, 60, 200)
    gc = np.asarray([sum(c in "GC" for c in s) / len(s) for s in seqs])
    return seqs, np.searchsorted(np.quantile(gc, [1 / 3, 2 / 3]), gc, side="right")


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("kind,k", [("logreg", 3), ("svm", 3), ("svm", 4)],
                         ids=["logreg-k3", "svm-k3-primal", "svm-k4-dual"])
def test_kmer_probes_match_jax(kind, k):
    seqs, y = three_class_dna(k, 90)
    new = random_dna(7, 20, 60, 200)
    fits = []
    for module in (jax_probes, probes):
        np.random.seed(11)  # LinearSVC draws liblinear's seed from numpy's global generator
        fits.append(getattr(module, f"fit_kmer_{kind}")(seqs, y, k=k))
    want, got = fits
    np.testing.assert_array_equal(got.y_pred, want.y_pred)
    np.testing.assert_allclose(got.y_proba, want.y_proba, rtol=0, atol=PROBA_ATOL)
    assert_same_metrics(got.metrics, want.metrics)
    np.testing.assert_array_equal(got.model.predict(got.vectorizer.transform(new)),
                                  want.model.predict(want.vectorizer.transform(new)))
    if kind == "svm":
        assert got.model.dual_ == (k == 4)


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("kind", ["logreg", "linear_svm"])
def test_embedding_probes_match_jax_and_pickle_as_pipelines(kind, tmp_path):
    X, y = linear_data(5, 150, 24, 3)
    X = (X * 3 + 1).astype(np.float32)
    want = getattr(jax_probes, f"fit_{kind}")(X, y)
    got = getattr(probes, f"fit_{kind}")(X, y)
    np.testing.assert_array_equal(got.y_pred, want.y_pred)
    np.testing.assert_allclose(got.y_proba, want.y_proba, rtol=0, atol=PROBA_ATOL)
    assert_same_metrics(got.metrics, want.metrics)
    assert list(got.model.named_steps) == list(want.model.named_steps) == ["scaler", "clf"]
    (tmp_path / "model.pkl").write_bytes(pickle.dumps(got.model))
    loaded = pickle.loads((tmp_path / "model.pkl").read_bytes())
    assert type(loaded).__name__ == "Pipeline"
    np.testing.assert_array_equal(loaded.predict(X), got.y_pred)
    if kind == "linear_svm":
        with pytest.raises(AttributeError):
            loaded.predict_proba(X)


BOOST_CASES = {"three_classes": (600, 20, 3, 40), "four_classes": (480, 16, 4, 25)}


@pytest.mark.parametrize("case", sorted(BOOST_CASES))
def test_multiclass_booster_is_sklearn_s(case):
    n, d, k, rounds = BOOST_CASES[case]
    rng = np.random.default_rng(k)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X[:, :k] + rng.normal(size=(n, k)), axis=1)
    fit = slice(0, n * 3 // 4)
    want = SkGBDT(max_iter=rounds).fit(X[fit], y[fit])
    got = HistGradientBoostingClassifier(max_iter=rounds).fit(X[fit], y[fit])
    assert got.n_iter_ == want.n_iter_ == rounds
    assert got.n_trees_per_iteration_ == want.n_trees_per_iteration_ == k
    for rows in (X[fit], X[n * 3 // 4:]):
        np.testing.assert_array_equal(got.predict(rows), want.predict(rows))
        np.testing.assert_allclose(got.predict_proba(rows), want.predict_proba(rows), rtol=0,
                                   atol=PROBA_ATOL)


# sha256 of the binary booster's raw scores on the rows below, written by the
# booster before the multiclass path was added: the binary path is unchanged
BINARY_RAW_SHA256 = "0326b677f54e254e3885a23cdf1484be723b1517b94e2e595ea3d10aed9ed977"


def test_binary_booster_unchanged():
    rng = np.random.default_rng(20)
    X = rng.normal(size=(600, 24)).astype(np.float32)
    y = (X[:, :3].sum(axis=1) + rng.normal(size=600) > 0.4).astype(int)
    model = HistGradientBoostingClassifier(max_iter=40).fit(X[:450], y[:450])
    raw = np.ascontiguousarray(model.decision_function(X), np.float64)
    assert model.n_trees_per_iteration_ == 1 and raw.ndim == 1
    assert hashlib.sha256(raw.tobytes()).hexdigest() == BINARY_RAW_SHA256


PCA_CASES = {"covariance_eigh": (1200, 40, 3), "full": (160, 64, 3),
             "randomized": (2000, 300, 16)}


@pytest.mark.parametrize("solver", sorted(PCA_CASES))
def test_pca_is_sklearn_s(solver):
    n, d, k = PCA_CASES[solver]
    rng = np.random.default_rng(d)
    X = (rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) + 2).astype(np.float32)
    want = SkPCA(n_components=k, random_state=42)
    got = clustering.PCA(k, random_state=42)
    want_t, got_t = want.fit_transform(X), got.fit_transform(X)
    assert got.svd_solver_ == want._fit_svd_solver == solver
    scale = float(np.abs(want_t).max())
    np.testing.assert_allclose(got.components_, want.components_, rtol=0, atol=PCA_ATOL)
    rows = np.arange(k)
    peak = np.argmax(np.abs(want.components_), axis=1)
    np.testing.assert_array_equal(np.sign(got.components_[rows, peak]),
                                  np.sign(want.components_[rows, peak]))
    assert np.abs(got_t - want_t).max() <= PCA_ATOL * scale
    assert np.abs(got.transform(X[:50]) - want.transform(X[:50])).max() <= PCA_ATOL * scale
    np.testing.assert_allclose(got.explained_variance_, want.explained_variance_, rtol=PCA_ATOL)


def blobs(seed, n, d, centers, noise=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-8, 8, size=(centers, d))
    X = means[rng.integers(0, centers, n)] + rng.normal(size=(n, d))
    if noise:
        X = np.concatenate([X, rng.uniform(-12, 12, size=(noise, d))])
    return X


KMEANS_CASES = {"blobs": (3000, 16, 20), "gaussian": (5000, 48, 30), "one_chunk": (168, 64, 4)}


@pytest.mark.parametrize("case", sorted(KMEANS_CASES))
def test_kmeans_is_sklearn_s(case):
    n, d, k = KMEANS_CASES[case]
    rng = np.random.default_rng(n)
    X = (blobs(n, n, d, k // 2) if case == "blobs" else rng.normal(size=(n, d))).astype(
        np.float32)
    want = SkKMeans(n_clusters=k, n_init="auto", random_state=42).fit(X)
    got = clustering.KMeans(n_clusters=k, random_state=42).fit(X)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.n_iter_ == want.n_iter_
    assert abs(got.inertia_ - want.inertia_) <= INERTIA_RTOL * want.inertia_
    assert got.inertia_ <= got.init_inertia_
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_, rtol=0,
                               atol=1e-6 * float(np.abs(want.cluster_centers_).max()))


def test_kmeans_relocates_an_empty_cluster_as_sklearn():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(700, 8)).astype(np.float32)
    centers = X[[0, 1, 2, 3]].copy()
    centers[2] = 1e3  # no row is nearest: the cluster empties and is relocated
    labels = clustering._labels(X, centers)
    got, got_shift = clustering._lloyd_step(X, centers, labels)
    want = np.zeros_like(centers)
    weight = np.zeros(4, np.float32)
    want_labels = np.full(700, -1, np.int32)
    shift = np.zeros(4, np.float32)
    lloyd_iter_chunked_dense(X, np.ones(700, np.float32), centers, want, weight, want_labels,
                             shift, 1)
    np.testing.assert_array_equal(labels, want_labels)
    assert 2 not in labels and np.all(weight > 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_shift, shift)


@pytest.mark.parametrize("min_cluster_size", [5, 15])
def test_hdbscan_is_sklearn_s(min_cluster_size):
    X = blobs(min_cluster_size, 400, 5, 4, noise=80)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # sklearn's `copy` default
        want = SkHDBSCAN(min_cluster_size=min_cluster_size).fit_predict(X)
    got = clustering.HDBSCAN(min_cluster_size=min_cluster_size).fit_predict(X)
    np.testing.assert_array_equal(got, want)
    assert -1 in got and len(set(got)) > 2


def test_confusion_matrix_is_sklearn_s():
    rng = np.random.default_rng(8)
    y, pred = rng.integers(0, 4, 90), rng.integers(1, 5, 90)
    for labels in (None, [0, 1, 2], [3, 1, 0, 2]):
        np.testing.assert_array_equal(estimators.confusion_matrix(y, pred, labels=labels),
                                      sk_confusion(y, pred, labels=labels))


def write_labelled(path, seqs, labels):
    path.write_text("id,sequence,label\n" + "".join(
        f"g{i},{s},{y}\n" for i, (s, y) in enumerate(zip(seqs, labels))))


def test_benchmark_xgboost_dna_matches_the_script(tmp_path, capsys, monkeypatch):
    from genomics_lm_torch.evals.benchmark_xgboost_dna import PORT_ENGINE
    from genomics_lm_torch.evals.benchmark_xgboost_dna import main as port_main
    from scripts.benchmark_xgboost_dna import main as jax_main

    # both CLIs bootstrap 100 resamples, not 1,000 (JAX's sklearn metrics took
    # ~14 s for those); compute_metrics is held to JAX's in test_torch_motifs_probes.py
    for module in (jax_metrics, metrics):
        monkeypatch.setattr(module, "compute_metrics",
                            functools.partial(module.compute_metrics, n_resamples=100))
    seqs, y = three_class_dna(12, 120)
    write_labelled(tmp_path / "train.csv", seqs[:90], y[:90])
    write_labelled(tmp_path / "test.csv", seqs[90:], y[90:])
    reports = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"{name}.json"
        assert main(["--train_csv", str(tmp_path / "train.csv"), "--test_csv",
                     str(tmp_path / "test.csv"), "--out", str(out)]) == 0
        reports[name] = json.loads(out.read_text())
    assert reports["jax"].pop("engine") == "sklearn_hist_gbdt (xgboost not installed)"
    assert reports["port"].pop("engine") == PORT_ENGINE
    assert reports["port"] == reports["jax"] and "auroc" in reports["port"]["test_metrics"]
    capsys.readouterr()


def test_probe_ss_linear_matches_the_script(tmp_path, capsys):
    from genomics_lm_torch.evals.probe_ss_linear import main as port_main
    from scripts.probe_ss_linear import main as jax_main

    rng = np.random.default_rng(3)
    N, T, D = 24, 30, 16
    H = rng.normal(size=(N, T, D)).astype(np.float32)
    Y = np.argmax(H[..., :3] + 0.8 * rng.normal(size=(N, T, 3)), axis=-1)
    M = (rng.random((N, T)) < 0.85).astype(np.int64)
    np.savez(tmp_path / "tokens.npz", H=H, Y=Y, M=M)
    reports = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / name
        assert main(["--emb_npz", str(tmp_path / "tokens.npz"), "--C", "0.5", "--seed", "2",
                     "--out_dir", str(out)]) == 0
        reports[name] = json.loads((out / "metrics.json").read_text())
    assert reports["port"] == reports["jax"]
    assert sum(reports["port"]["per_class"][c]["support"] for c in "CHE") == \
        reports["port"]["test_tokens"]
    capsys.readouterr()
