"""Markov perplexity baselines with <SEP> history reset (the port's own
copy of ``genomics_lm_tpu/evals/markov.py``, numpy only).

Additive-smoothed uniform / unigram / bigram / trigram baselines over
packed (X, Y) rows: PAD targets skipped, active vocabulary = vocab minus
PAD, the trigram history reset across <SEP> boundaries, and an unseen
trigram context backing off to its bigram row. Smoothing:
``(count + α) / (total_over_non_PAD + α·(V−1))``.

Table-driven: each row becomes flat ``(prev2, prev, target)`` context
arrays once; counting is a ``bincount`` over packed context keys into dense
``V``/``V²``/``V³`` tables (sparse ``np.unique`` accumulation above
``_DENSE_VOCAB_LIMIT``), and evaluation gathers the smoothed probabilities
for a whole row at a time. Every number is float64 and equals JAX's
(``tests/test_torch_baselines.py``).
"""

from __future__ import annotations

import math

import numpy as np

PAD_ID = 0
MODEL_NAMES = ("Uniform", "Unigram", "Bigram", "Trigram")

# Tokens accumulated before a chunked bincount drain during fitting; bounds
# the size of the temporary key arrays without a Python-level token loop.
_FIT_CHUNK_TOKENS = 1 << 20

# Above this vocabulary size the dense V³ trigram bincount table (V=256 →
# 128 MiB int64) gives way to sparse np.unique accumulation keyed by packed
# context — still vectorized per chunk, memory proportional to observed
# contexts like the reference's dict-of-counts.
_DENSE_VOCAB_LIMIT = 256


def _contexts_for_row(x, y, reset: np.ndarray):
    """``(prev2, prev, target)`` arrays for one row's non-PAD targets.

    ``prev`` is the conditioning token x[t]; ``prev2`` is x[t-1], forced to
    PAD at position 0 and wherever x[t] is a reset token (the trigram
    history restart at <SEP> boundaries). Returns None for rows with no
    evaluable targets.
    """
    prev = np.asarray(x, dtype=np.int64).ravel()
    target = np.asarray(y, dtype=np.int64).ravel()
    prev2 = np.concatenate(([PAD_ID], prev[:-1]))
    if reset.size:
        prev2 = np.where(np.isin(prev, reset), PAD_ID, prev2)
    keep = target != PAD_ID
    if not keep.any():
        return None
    return prev2[keep], prev[keep], target[keep]


def _row_contexts(xs, ys, reset_token_ids):
    """Yield per-row ``(prev2, prev, target)`` arrays for non-PAD targets."""
    reset = np.asarray(sorted(reset_token_ids), dtype=np.int64)
    for x, y in zip(xs, ys):
        triple = _contexts_for_row(x, y, reset)
        if triple is not None:
            yield triple


def fit_baselines(
    xs: np.ndarray,
    ys: np.ndarray,
    vocab_size: int,
    alpha: float = 0.01,
    *,
    reset_token_ids: frozenset = frozenset(),
):
    """Count-based (unigram, bigram, trigram) models over non-PAD targets.

    Returns ``(unigram_counts, bigram, trigram)`` where ``bigram`` maps
    ``prev -> count row`` and ``trigram`` maps ``(prev2, prev) -> count
    row`` — only contexts that actually occurred carry an entry, mirroring
    the sparse structure evaluation's backoff test relies on.
    """
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    V = int(vocab_size)
    dense = V <= _DENSE_VOCAB_LIMIT
    uni_table = np.zeros(V, dtype=np.int64)
    bi_table = np.zeros(V * V, dtype=np.int64) if dense else None
    tri_table = np.zeros(V * V * V, dtype=np.int64) if dense else None
    bi_sparse: dict[int, np.ndarray] = {}
    tri_sparse: dict[int, np.ndarray] = {}

    def _accumulate_sparse(ctx_keys, target, store) -> None:
        # one pass of np.unique over packed (context, target) keys; the only
        # Python loop is over DISTINCT contexts in this chunk
        packed = ctx_keys * V + target
        uniq, cnt = np.unique(packed, return_counts=True)
        ctxs = uniq // V
        tgts = uniq % V
        starts = np.concatenate(
            ([0], np.flatnonzero(np.diff(ctxs)) + 1, [uniq.size]))
        for lo, hi in zip(starts[:-1], starts[1:]):
            row = store.get(int(ctxs[lo]))
            if row is None:
                row = store[int(ctxs[lo])] = np.zeros(V, dtype=np.int64)
            row[tgts[lo:hi]] += cnt[lo:hi]

    pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    pending_tokens = 0

    def _drain() -> None:
        nonlocal pending, pending_tokens
        if not pending:
            return
        prev2 = np.concatenate([p2 for p2, _, _ in pending])
        prev = np.concatenate([p for _, p, _ in pending])
        target = np.concatenate([t for _, _, t in pending])
        uni_table[:] += np.bincount(target, minlength=V)
        if dense:
            bi_table[:] += np.bincount(prev * V + target, minlength=V * V)
            tri_table[:] += np.bincount(
                (prev2 * V + prev) * V + target, minlength=V * V * V
            )
        else:
            _accumulate_sparse(prev, target, bi_sparse)
            _accumulate_sparse(prev2 * V + prev, target, tri_sparse)
        pending, pending_tokens = [], 0

    for triple in _row_contexts(xs, ys, reset_token_ids):
        pending.append(triple)
        pending_tokens += triple[2].size
        if pending_tokens >= _FIT_CHUNK_TOKENS:
            _drain()
    _drain()

    if int(uni_table.sum()) == 0:
        raise ValueError("training dataset has no evaluable non-PAD targets")

    if dense:
        bi_table = bi_table.reshape(V, V)
        tri_table = tri_table.reshape(V * V, V)
        bigram = {
            int(p): bi_table[p] for p in np.flatnonzero(bi_table.sum(axis=1))
        }
        trigram = {
            (int(key // V), int(key % V)): tri_table[key]
            for key in np.flatnonzero(tri_table.sum(axis=1))
        }
    else:
        bigram = bi_sparse
        trigram = {
            (int(key // V), int(key % V)): row
            for key, row in tri_sparse.items()
        }
    return uni_table, bigram, trigram


def _dense_tables(counts, vocab_size: int):
    """Expand the sparse fitted counts into dense float lookup tables.

    Totals sum only non-PAD target columns (column 0 is never incremented
    during fitting, so this matches the reference's ``counts[1:].sum()``).
    """
    unigram, bigram, trigram = counts
    V = vocab_size
    uni = np.asarray(unigram, dtype=np.float64)
    bi = np.zeros((V, V), dtype=np.float64)
    for prev, row in bigram.items():
        bi[int(prev)] = row
    tri = np.zeros((V * V, V), dtype=np.float64)
    for (prev2, prev), row in trigram.items():
        tri[int(prev2) * V + int(prev)] = row
    return uni, bi, tri


def _sparse_lookup(store: dict, totals: dict, ctx: np.ndarray,
                   target: np.ndarray):
    """``(count[ctx, target], total[ctx], seen[ctx])`` from dict-of-rows.

    Vectorized per chunk: positions are grouped by DISTINCT context (the
    only Python loop), so memory and time follow observed contexts — the
    sparse-eval counterpart of the dense table gathers.
    """
    count = np.zeros(ctx.shape, dtype=np.float64)
    total = np.zeros(ctx.shape, dtype=np.float64)
    seen = np.zeros(ctx.shape, dtype=bool)
    order = np.argsort(ctx, kind="stable")
    sorted_ctx = ctx[order]
    starts = np.concatenate(
        ([0], np.flatnonzero(np.diff(sorted_ctx)) + 1, [ctx.size]))
    for lo, hi in zip(starts[:-1], starts[1:]):
        key = int(sorted_ctx[lo])
        row = store.get(key)
        if row is None:
            continue
        idx = order[lo:hi]
        count[idx] = row[target[idx]]
        total[idx] = totals[key]
        seen[idx] = totals[key] > 0
    return count, total, seen


def _make_row_nll_fn(counts, vocab_size: int, alpha: float):
    """Closure computing per-model NLL *sums* for one row's contexts.

    Shared by corpus evaluation and the per-row path the paired bootstrap
    needs (``per_row_baseline_nll``); identical smoothing/backoff math.
    """
    V = int(vocab_size)
    active = V - 1
    dense = V <= _DENSE_VOCAB_LIMIT
    if dense:
        uni, bi, tri = _dense_tables(counts, V)
        uni_total = uni[1:].sum()
        bi_totals = bi[:, 1:].sum(axis=1)
        tri_totals = tri[:, 1:].sum(axis=1)
    else:
        # above the dense-table bound, gather from the sparse fitted dicts
        # directly (the dense V² / V³ expansions are exactly what the
        # sparse fit path exists to avoid)
        unigram_counts, bigram_store, trigram_tuple_store = counts
        uni = np.asarray(unigram_counts, dtype=np.float64)
        uni_total = uni[1:].sum()
        bigram_store = {int(p): np.asarray(r) for p, r in bigram_store.items()}
        trigram_store = {
            int(p2) * V + int(p): np.asarray(r)
            for (p2, p), r in trigram_tuple_store.items()
        }
        bi_row_totals = {k: float(r[1:].sum()) for k, r in bigram_store.items()}
        tri_row_totals = {k: float(r[1:].sum()) for k, r in trigram_store.items()}
    smooth = alpha * active

    def row_nll(prev2, prev, target) -> dict:
        out = {"Uniform": target.size * math.log(active)}
        out["Unigram"] = -float(
            np.log((uni[target] + alpha) / (uni_total + smooth)).sum()
        )
        if dense:
            bi_count = bi[prev, target]
            bi_total = bi_totals[prev]
            context = prev2 * V + prev
            seen = tri_totals[context] > 0
            tri_count_raw = tri[context, target]
            tri_total_raw = tri_totals[context]
        else:
            bi_count, bi_total, _ = _sparse_lookup(
                bigram_store, bi_row_totals, prev, target)
            tri_count_raw, tri_total_raw, seen = _sparse_lookup(
                trigram_store, tri_row_totals, prev2 * V + prev, target)
        out["Bigram"] = -float(
            np.log((bi_count + alpha) / (bi_total + smooth)).sum()
        )
        # Trigram with backoff: contexts never seen in training fall back to
        # the bigram row for the same ``prev`` (reference backoff branch).
        tri_count = np.where(seen, tri_count_raw, bi_count)
        tri_total = np.where(seen, tri_total_raw, bi_total)
        out["Trigram"] = -float(
            np.log((tri_count + alpha) / (tri_total + smooth)).sum()
        )
        return out

    return row_nll


def per_row_baseline_nll(
    xs: np.ndarray,
    ys: np.ndarray,
    counts,
    vocab_size: int,
    alpha: float = 0.01,
    *,
    reset_token_ids: frozenset = frozenset(),
):
    """Per-packed-row NLL sums and token counts for every baseline.

    The row (packed window) is the resampling unit of the paired bootstrap
    (``evals.significance``): pairing with ``perplexity.per_row_model_nll``
    holds because both walk the split in dataset row order. Rows with no
    evaluable target contribute zeros.
    """
    row_fn = _make_row_nll_fn(counts, vocab_size, alpha)
    reset = np.asarray(sorted(reset_token_ids), dtype=np.int64)
    n = len(xs)
    nll_rows = {name: np.zeros(n, dtype=np.float64) for name in MODEL_NAMES}
    tokens_rows = np.zeros(n, dtype=np.int64)
    for i, (x, y) in enumerate(zip(xs, ys)):
        triple = _contexts_for_row(x, y, reset)
        if triple is None:
            continue
        sums = row_fn(*triple)
        tokens_rows[i] = triple[2].size
        for name in MODEL_NAMES:
            nll_rows[name][i] = sums[name]
    return nll_rows, tokens_rows


def evaluate_baselines(
    xs: np.ndarray,
    ys: np.ndarray,
    counts,
    vocab_size: int,
    alpha: float = 0.01,
    *,
    reset_token_ids: frozenset = frozenset(),
):
    """Per-model NLL/PPL/bits + improvement over the best simple model."""
    row_fn = _make_row_nll_fn(counts, vocab_size, alpha)
    nll = dict.fromkeys(MODEL_NAMES, 0.0)
    tokens = 0
    for prev2, prev, target in _row_contexts(xs, ys, reset_token_ids):
        tokens += target.size
        sums = row_fn(prev2, prev, target)
        for name in MODEL_NAMES:
            nll[name] += sums[name]

    if tokens == 0:
        raise ValueError("test dataset has no evaluable non-PAD targets")

    results = {
        name: {
            "cross_entropy_nats": nll[name] / tokens,
            "perplexity": math.exp(nll[name] / tokens),
            "bits_per_codon": nll[name] / tokens / math.log(2),
        }
        for name in MODEL_NAMES
    }
    best_name = min(
        (n for n in MODEL_NAMES if n != "Uniform"),
        key=lambda n: results[n]["cross_entropy_nats"],
    )
    best = results[best_name]["cross_entropy_nats"]
    for metrics in results.values():
        metrics["cross_entropy_improvement_over_best_simple"] = (
            best - metrics["cross_entropy_nats"]
        )
    return results, tokens, best_name


__all__ = [
    "MODEL_NAMES",
    "evaluate_baselines",
    "fit_baselines",
    "per_row_baseline_nll",
]
