"""The port's estimators (``evals/estimators.py``, ``evals/hist_gbdt.py``)
against sklearn, the release the JAX package's scripts run against.

- ``train_test_split``, ``StratifiedKFold`` and ``StratifiedGroupKFold`` give
  sklearn's index sets, over hypothesis-drawn sizes, class mixes, groups,
  fold counts and seeds;
- ``StandardScaler`` and ``Ridge`` (both sides of ``n_features = n_samples``,
  float32 and float64) within 1e-8 of sklearn's;
- ``LogisticRegression`` (binary, balanced, multinomial; float32 and
  float64): predictions equal and probabilities within ``PROBA_ATOL``;
- the gradient-boosted trees on two seeded binary sets of 1,000 x 64 (60
  rounds, and the baselines' 150): predictions equal
  and probabilities within ``PROBA_ATOL``; the early
  stopping rule above 10,000 rows; three classes fit, one class and missing
  values refused;
- every module of the slice imports and runs with sklearn, xgboost, umap
  and matplotlib blocked, in a fresh interpreter.
"""

from __future__ import annotations

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from sklearn import linear_model as sk_lm
from sklearn import model_selection as sk_ms
from sklearn import preprocessing as sk_pp
from sklearn.ensemble import HistGradientBoostingClassifier as SkGBDT
from sklearn.metrics import f1_score as sk_f1
from threadpoolctl import threadpool_limits

from genomics_lm_torch.evals import estimators as est
from genomics_lm_torch.evals import hist_gbdt
from genomics_lm_torch.evals.hist_gbdt import HistGradientBoostingClassifier

REPO = Path(__file__).resolve().parent.parent
# The port runs sklearn's float operations in sklearn's order and dtypes: its
# fits come out bit-equal or within 3e-15 on these inputs; the bound leaves room for a
# libm's exp or log1p one ulp apart, carried through the L-BFGS-B iterates or
# the boosting rounds, and stays far below any probability that moves a call.
PROBA_ATOL = 1e-6
RIDGE_ATOL = 1e-8
SPLIT = settings(max_examples=40, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(scope="module", autouse=True)
def _one_native_thread():
    """sklearn's booster runs OpenMP loops over every core and BLAS threads
    its products; beside the suite's other workers those threads wait on one
    another (a 5 s fit took over 700 s). One thread each: the same sums in
    the same order, so the same results."""
    with threadpool_limits(limits=1):
        yield


def _same_splits(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (tr_a, te_a), (tr_b, te_b) in zip(a, b):
        np.testing.assert_array_equal(tr_a, tr_b)
        np.testing.assert_array_equal(te_a, te_b)


@SPLIT
@given(n=st.integers(4, 300), test_size=st.sampled_from([0.1, 0.25, 0.5, 3]),
       seed=st.integers(0, 2**31 - 1))
def test_train_test_split_is_sklearn_s(n, test_size, seed):
    X = np.arange(n * 2).reshape(n, 2)
    y = np.arange(n)
    want = sk_ms.train_test_split(X, y, test_size=test_size, random_state=seed)
    got = est.train_test_split(X, y, test_size=test_size, random_state=seed)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@SPLIT
@given(data=st.data(), n_splits=st.integers(2, 6), seed=st.integers(0, 2**31 - 1),
       labels=st.sampled_from(["int", "str"]))
def test_stratified_kfold_is_sklearn_s(data, n_splits, seed, labels):
    counts = data.draw(st.lists(st.integers(1, 40), min_size=2, max_size=4))
    if max(counts) < n_splits or sum(counts) < n_splits:
        counts[0] = n_splits
    y = np.concatenate([np.full(c, k) for k, c in enumerate(counts)])
    y = np.random.default_rng(seed % 1000).permutation(y)
    if labels == "str":
        y = np.asarray(["abc"[k % 3] + str(k) for k in y])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a class under n_splits: both warn
        _same_splits(
            est.StratifiedKFold(n_splits, shuffle=True, random_state=seed).split(y, y),
            sk_ms.StratifiedKFold(n_splits, shuffle=True, random_state=seed).split(y, y))
        _same_splits(est.StratifiedKFold(n_splits).split(y, y),
                     sk_ms.StratifiedKFold(n_splits).split(y, y))


@SPLIT
@given(data=st.data(), n_splits=st.integers(2, 5), seed=st.integers(0, 2**31 - 1))
def test_stratified_group_kfold_is_sklearn_s(data, n_splits, seed):
    n = data.draw(st.integers(n_splits * 3, 160))
    n_groups = data.draw(st.integers(n_splits, max(n_splits, n // 2)))
    n_classes = data.draw(st.integers(2, 3))
    rng = np.random.default_rng(seed % 10_000)
    y = rng.integers(0, n_classes, n)
    y[:n_classes] = np.arange(n_classes)
    y[n_classes: n_classes + n_splits] = 0  # one class reaches n_splits
    groups = rng.integers(0, n_groups, n)
    groups[:n_groups] = np.arange(n_groups)
    groups = np.asarray([f"g{g}" for g in groups])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        _same_splits(
            est.StratifiedGroupKFold(n_splits, shuffle=True, random_state=seed).split(y, y,
                                                                                      groups),
            sk_ms.StratifiedGroupKFold(n_splits, shuffle=True, random_state=seed).split(
                y, y, groups))


def test_split_refusals_are_sklearn_s():
    y = np.array([0, 0, 1, 1, 1])
    for ours, theirs in ((est.StratifiedKFold(6), sk_ms.StratifiedKFold(6)),
                         (est.StratifiedGroupKFold(3), sk_ms.StratifiedGroupKFold(3))):
        for model in (ours, theirs):
            with pytest.raises(ValueError):
                list(model.split(y, y, np.array([0, 0, 1, 1, 1])))
    with pytest.raises(ValueError):
        est.StratifiedKFold(3, random_state=0)  # a seed without shuffle: sklearn refuses too
    with pytest.raises(ValueError):
        est.train_test_split(np.arange(3), test_size=3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scaler_is_sklearn_s(dtype):
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(200, 12)) * rng.uniform(0.01, 50, 12) + 7).astype(dtype)
    X[:, 4] = 0.3  # a constant column: its scale is 1
    want = sk_pp.StandardScaler().fit(X)
    got = est.StandardScaler().fit(X)
    np.testing.assert_array_equal(got.scale_, want.scale_)
    np.testing.assert_allclose(got.mean_, want.mean_, rtol=0, atol=1e-12)
    out = got.transform(X)
    assert out.dtype == want.transform(X).dtype
    np.testing.assert_allclose(out, want.transform(X), rtol=0, atol=RIDGE_ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(120, 30), (30, 30), (25, 90)], ids=["tall", "square", "wide"])
def test_ridge_is_sklearn_s(shape, dtype):
    rng = np.random.default_rng(shape[1])
    X = rng.normal(size=shape).astype(dtype)
    y = X[:, :3].sum(axis=1) + rng.normal(size=shape[0])
    want = sk_lm.Ridge(alpha=1.0).fit(X, y)
    got = est.Ridge(alpha=1.0).fit(X, y)
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=0, atol=RIDGE_ATOL)
    assert abs(float(got.intercept_) - float(want.intercept_)) <= RIDGE_ATOL
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=0, atol=RIDGE_ATOL)


def _classes(rng, n, d, k):
    X = rng.normal(size=(n, d))
    W = rng.normal(size=(d, k))
    y = np.argmax(X @ W + 1.5 * rng.normal(size=(n, k)), axis=1)
    if k == 2:  # an imbalanced binary set: about a fifth positive
        y = (X @ W[:, 0] + rng.normal(size=n) > 1.2).astype(int)
    return X, y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k,class_weight", [(2, None), (2, "balanced"), (3, None),
                                            (4, "balanced")])
def test_logistic_regression_is_sklearn_s(k, class_weight, dtype):
    rng = np.random.default_rng(10 * k + (class_weight is None))
    X, y = _classes(rng, 400, 40, k)
    X = sk_pp.StandardScaler().fit_transform(X.astype(dtype))
    X_new = rng.normal(size=(100, 40)).astype(dtype)
    labels = np.asarray(["neg", "pos", "mid", "top"])[y]  # string labels, sorted as sklearn's
    for C in (1.0, 0.05):
        want = sk_lm.LogisticRegression(C=C, max_iter=2000, class_weight=class_weight)
        got = est.LogisticRegression(C=C, max_iter=2000, class_weight=class_weight)
        want.fit(X, labels)
        got.fit(X, labels)
        np.testing.assert_array_equal(got.classes_, want.classes_)
        for rows in (X, X_new):
            np.testing.assert_array_equal(got.predict(rows), want.predict(rows))
            np.testing.assert_allclose(got.predict_proba(rows), want.predict_proba(rows),
                                       rtol=0, atol=PROBA_ATOL)
            np.testing.assert_allclose(got.decision_function(rows),
                                       want.decision_function(rows), rtol=0, atol=1e-5)
        assert got.coef_.dtype == want.coef_.dtype


def test_standardized_logistic_regression_is_fit_logreg_s_pipeline():
    from genomics_lm_tpu.evals.probes import fit_logreg

    rng = np.random.default_rng(5)
    X, y = _classes(rng, 300, 24, 3)
    X = (X * 20 + 3).astype(np.float32)
    want = fit_logreg(X, y, C=0.5).model
    got = est.standardized(est.LogisticRegression(C=0.5, max_iter=2000)).fit(X, y)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    np.testing.assert_allclose(got.predict_proba(X), want.predict_proba(X), rtol=0,
                               atol=PROBA_ATOL)


def test_f1_is_sklearn_s():
    rng = np.random.default_rng(1)
    for _ in range(20):
        y_true, y_pred = rng.integers(0, 2, 30), rng.integers(0, 2, 30)
        assert est.f1_score(y_true, y_pred) == sk_f1(y_true, y_pred)
    none = np.zeros(6, int)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert est.f1_score(none, none) == sk_f1(none, none) == 0.0
        assert est.f1_score(none, none + 1) == sk_f1(none, none + 1) == 0.0


@pytest.mark.parametrize("seed,max_iter", [(0, 60), (1, 150)],
                         ids=["gaussian", "codon_frequencies_baseline"])
def test_gbdt_is_sklearn_s(seed, max_iter):
    rng = np.random.default_rng(seed)
    n, d = 1000, 64
    if seed == 0:
        X = rng.normal(size=(n, d)).astype(np.float32)
    else:  # codon-frequency-like columns: ties, some under 255 distinct values
        X = (rng.integers(0, 40, size=(n, d)) / rng.integers(40, 400, size=(n, 1))).astype(
            np.float32)
    score = X @ rng.normal(size=d)
    y = (score + 0.5 * rng.normal(size=n) > np.quantile(score, 0.8)).astype(int)
    X_fit, y_fit, X_new = X[:800], y[:800], X[800:]
    want = SkGBDT(max_iter=max_iter).fit(X_fit, y_fit)
    got = HistGradientBoostingClassifier(max_iter=max_iter).fit(X_fit, y_fit)
    assert got.n_iter_ == want.n_iter_ == max_iter and not got.do_early_stopping_
    for rows in (X_fit, X_new):
        np.testing.assert_array_equal(got.predict(rows), want.predict(rows))
        np.testing.assert_allclose(got.predict_proba(rows), want.predict_proba(rows), rtol=0,
                                   atol=PROBA_ATOL)


def test_gbdt_early_stopping_rule_above_10000_rows():
    rng = np.random.default_rng(7)
    n = 12_000
    X = rng.normal(size=(n, 3))
    y = (X[:, 0] + 2.0 * rng.normal(size=n) > 0).astype(int)  # mostly noise: it stops early
    model = HistGradientBoostingClassifier(max_iter=200, random_state=3).fit(X, y)
    scores = model.validation_score_
    assert model.do_early_stopping_ and 11 < model.n_iter_ < 200
    assert len(scores) == len(model.train_score_) == model.n_iter_ + 1  # the baseline's too
    # stopped at the first round whose last 10 scores beat none of the one before them
    ref = hist_gbdt.N_ITER_NO_CHANGE + 1

    def stops(k):  # after the first k scores
        return k >= ref and not any(s > scores[k - ref] + hist_gbdt.TOL
                                    for s in scores[k - ref + 1:k])

    assert stops(len(scores)) and not any(stops(k) for k in range(1, len(scores)))
    again = HistGradientBoostingClassifier(max_iter=200, random_state=3).fit(X, y)
    assert again.validation_score_ == scores  # the held-out rows come from the seed
    assert HistGradientBoostingClassifier(max_iter=5).fit(X[:10_000], y[:10_000]).n_iter_ == 5


def test_gbdt_refuses_multiclass():
    """Three classes now fit, one tree a class a round (held to sklearn in
    ``test_torch_classifiers.py``); one class and missing values are refused."""
    X = np.random.default_rng(0).normal(size=(60, 2))
    model = HistGradientBoostingClassifier(max_iter=3).fit(X, np.arange(60) % 3)
    assert model.n_trees_per_iteration_ == 3 and len(model.trees_[0]) == 3
    assert model.predict_proba(X).shape == (60, 3)
    with pytest.raises(ValueError, match="at least two"):
        HistGradientBoostingClassifier().fit(X, np.zeros(60))
    X[0, 0] = np.nan
    with pytest.raises(ValueError, match="missing values"):
        HistGradientBoostingClassifier().fit(X, np.arange(60) % 2)


NO_SKLEARN = r"""
import sys
for name in ("sklearn", "xgboost", "umap", "matplotlib"):
    sys.modules[name] = None
import importlib, json
import numpy as np
mods = {mods!r}
for m in mods:
    importlib.import_module("genomics_lm_torch.evals." + m)
from genomics_lm_torch.evals import estimators as est
from genomics_lm_torch.evals import hist_gbdt
from genomics_lm_torch.evals.hist_gbdt import HistGradientBoostingClassifier
rng = np.random.default_rng(0)
X = rng.normal(size=(120, 6)).astype(np.float32)
y = (X[:, 0] + rng.normal(size=120) > 0.5).astype(int)
g = rng.integers(0, 12, 120)
for tr, te in est.StratifiedGroupKFold(3, shuffle=True, random_state=1).split(X, y, g):
    m = est.standardized(est.LogisticRegression(max_iter=2000, class_weight="balanced"))
    m.fit(X[tr], y[tr])
    est.f1_score(y[te], m.predict(X[te]))
for tr, te in est.StratifiedKFold(3, shuffle=True, random_state=1).split(X, y):
    HistGradientBoostingClassifier(max_iter=5).fit(X[tr], y[tr]).predict_proba(X[te])
a, b, c, d = est.train_test_split(X, y.astype(float), random_state=0)
est.Ridge().fit(a, c).predict(b)
est.LogisticRegression().fit(X, np.arange(120) % 3).predict_proba(X)
print(json.dumps(sorted(k for k in sys.modules if k.split(".")[0] in
                        ("sklearn", "xgboost", "umap", "matplotlib") and sys.modules[k])))
"""

SLICE = ["estimators", "hist_gbdt", "benchmark_gene_essentiality",
         "benchmark_essentiality_baselines", "probe_structural_awareness",
         "probe_structural_regression", "eval_shape_baselines", "select_grouped_representation",
         "probe_next_token", "generate_probe_labels", "ss_propensity", "disorder_heuristics",
         "filter_cds_by_pdb", "audit_structural_motifs"]


def test_the_slice_runs_without_sklearn():
    proc = subprocess.run([sys.executable, "-c", NO_SKLEARN.format(mods=SLICE)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
