"""Device synchronization by a fetched checksum (twin of
``genomics_lm_tpu/utils/sync.py``).

``hard_sync`` fetches a float32 scalar sum of a tree's first leaf, which
drains the queue up to the work that produced it, then synchronizes the
card the leaf lives on, so a host clock read after it covers every launch
queued before it. The leaves are ordered as ``jax.tree.leaves`` orders
them: a dict by its sorted keys, a list or tuple in order; a module gives
its first parameter.
"""

from __future__ import annotations

import torch


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, torch.nn.Module):
        return next(tree.parameters())
    if isinstance(tree, dict):
        return _first_leaf(tree[sorted(tree)[0]])
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return torch.as_tensor(tree)


def hard_sync(tree) -> float:
    """Drain the device queue; returns a checksum scalar of the first leaf."""
    leaf = _first_leaf(tree)
    checksum = float(leaf.detach().sum().to(torch.float32))
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return checksum


__all__ = ["hard_sync"]
