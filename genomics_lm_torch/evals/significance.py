"""Paired bootstrap CIs for model-vs-baseline NLL margins (the port's own
copy of ``genomics_lm_tpu/evals/significance.py``, numpy only).

- The resampling unit is the packed window (a row of the split's X/Y), the
  exchangeable unit of a packed corpus; resampling tokens would ignore the
  dependence within a window and understate the variance.
- Model and baseline NLL sums come from the SAME resampled rows
  (``perplexity.per_row_model_nll`` / ``markov.per_row_baseline_nll``,
  both in dataset row order), so the margin's distribution is that of the
  difference.
- Each draw recomputes both token-weighted corpus NLLs over the resampled
  rows and takes their difference; the CI is the percentile interval.

Positive margin = the model beats the baseline (baseline NLL − model NLL,
in nats per token).
"""

from __future__ import annotations

import numpy as np

__all__ = ["paired_bootstrap_margins"]


def paired_bootstrap_margins(
    model_nll_rows: np.ndarray,
    tokens_rows: np.ndarray,
    baseline_nll_rows: dict[str, np.ndarray],
    *,
    n_boot: int = 2000,
    seed: int = 0,
    ci: float = 0.95,
) -> dict:
    """95% (default) percentile CIs on per-token NLL margins.

    Returns ``{baseline_name: {margin_nats, ci_low, ci_high, excludes_zero,
    n_boot, n_rows}}`` with margin = baseline − model corpus NLL (nats per
    token, positive = model better). Rows with zero tokens are dropped
    before resampling (they carry no signal and would dilute draws).
    """
    model_nll_rows = np.asarray(model_nll_rows, dtype=np.float64)
    tokens_rows = np.asarray(tokens_rows, dtype=np.float64)
    keep = tokens_rows > 0
    model_nll_rows = model_nll_rows[keep]
    tokens_rows = tokens_rows[keep]
    n_rows = int(keep.sum())
    if n_rows < 2:
        raise ValueError("paired bootstrap needs at least 2 non-empty rows")

    total_tokens = tokens_rows.sum()
    model_point = model_nll_rows.sum() / total_tokens

    rng = np.random.default_rng(seed)
    # one index matrix shared by every baseline: the draws are paired
    # across baselines too, so margin *differences* between baselines are
    # themselves comparable across the report
    draws = rng.integers(0, n_rows, size=(n_boot, n_rows))
    boot_tokens = tokens_rows[draws].sum(axis=1)
    boot_model = model_nll_rows[draws].sum(axis=1) / boot_tokens

    lo_q = (1.0 - ci) / 2.0
    out = {}
    for name, base_rows in baseline_nll_rows.items():
        base_rows = np.asarray(base_rows, dtype=np.float64)[keep]
        point = base_rows.sum() / total_tokens - model_point
        boot_margin = base_rows[draws].sum(axis=1) / boot_tokens - boot_model
        ci_low, ci_high = np.quantile(boot_margin, [lo_q, 1.0 - lo_q])
        out[name] = {
            "margin_nats": float(point),
            "ci_low": float(ci_low),
            "ci_high": float(ci_high),
            "excludes_zero": bool(ci_low > 0.0 or ci_high < 0.0),
            "n_boot": int(n_boot),
            "n_rows": n_rows,
            "ci_level": ci,
        }
    return out
