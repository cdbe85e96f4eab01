"""The port's cross-entropy against the JAX package's on the same inputs.

``cross_entropy`` and ``cross_entropy_parts`` must keep torch's weighted
mean semantics exactly as the JAX twin does: the class weight inside the
smoothing sum, the denominator sum_i w_{y_i} over valid samples, and
``valid_mask`` composed with ``ignore_index``. Float32 on the CPU,
tolerance 1e-6 relative (the two frameworks sum in different orders).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.ops import losses as jax_losses
from genomics_lm_torch.ops import losses

RTOL = 1e-6
CASES = list(itertools.product((0.0, 0.1), (False, True), (False, True)))


def make_inputs(seed: int):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(3, 17, 68))).astype(np.float32)
    targets = rng.integers(0, 68, (3, 17)).astype(np.int32)
    targets[:, -3:] = 0  # pad targets, ignored
    weight = rng.uniform(0.2, 2.0, 68).astype(np.float32)
    valid = rng.random((3, 17)) < 0.8
    return logits, targets, weight, valid


@pytest.mark.parametrize("smoothing,weighted,masked", CASES,
                         ids=[f"eps{e}-w{int(w)}-m{int(m)}" for e, w, m in CASES])
def test_cross_entropy_matches_jax(smoothing, weighted, masked):
    logits, targets, weight, valid = make_inputs(int(10 * smoothing) + 2 * weighted + masked)
    kw = dict(label_smoothing=smoothing)
    jkw = dict(kw, weight=jnp.asarray(weight) if weighted else None,
               valid_mask=jnp.asarray(valid) if masked else None)
    tkw = dict(kw, weight=torch.from_numpy(weight) if weighted else None,
               valid_mask=torch.from_numpy(valid) if masked else None)
    want = float(jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(targets), **jkw))
    want_n, want_d = (float(a) for a in jax_losses.cross_entropy_parts(
        jnp.asarray(logits), jnp.asarray(targets), **jkw))
    t_logits, t_targets = torch.from_numpy(logits), torch.from_numpy(targets)
    got = float(losses.cross_entropy(t_logits, t_targets, **tkw))
    got_n, got_d = (float(a) for a in losses.cross_entropy_parts(t_logits, t_targets, **tkw))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose([got_n, got_d], [want_n, want_d], rtol=RTOL)


def test_bf16_logits_are_upcast_and_all_ignored_gives_zero():
    logits, targets, _, _ = make_inputs(7)
    bf16 = torch.from_numpy(logits).to(torch.bfloat16)
    got = losses.cross_entropy(bf16, torch.from_numpy(targets))
    assert got.dtype == torch.float32
    want = jax_losses.cross_entropy(jnp.asarray(bf16.float().numpy()), jnp.asarray(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    pads = torch.zeros_like(torch.from_numpy(targets))
    assert float(losses.cross_entropy(bf16, pads)) == 0.0
