"""What the protein trainers share: the device, AdamW at optax's semantics,
the optimizer state in the checkpoint, batches on the device, and the
model's start (a fresh draw, a JAX tree, a checkpoint)."""

from __future__ import annotations

import numpy as np
import torch

from genomics_lm_torch.training.lifecycle import RunLifecycleError
from genomics_lm_torch.utils.device import resolve_device
from genomics_lm_torch.utils.weights import protein_params_from_jax, protein_params_to_jax

OPTIMIZER_FORMAT = "torch.optim.AdamW/by-parameter-name/v1"


def adamw(model: torch.nn.Module, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """optax ``adamw(lr, weight_decay=...)``: decay on every leaf, eps 1e-8
    outside the square root (torch's AdamW is the same update)."""
    return torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def apply_accumulated(optimizer: torch.optim.Optimizer, n_acc: int = 1) -> None:
    """Step on the mean of ``n_acc`` accumulated microbatch gradients (JAX
    sums the gradients and divides by the group's own size), then clear. A
    parameter the loss does not reach (the backbone's final layer norm off
    the feature path) steps on a zero gradient, as optax updates every leaf:
    its weight decay still applies."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.div_(n_acc)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def optimizer_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> dict:
    """AdamW's state keyed by parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [p for group in optimizer.param_groups for p in group["params"]]
    state = optimizer.state_dict()["state"]
    return {"format": OPTIMIZER_FORMAT,
            "state": {names[id(order[i])]: dict(s) for i, s in state.items()}}


def load_optimizer_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                         saved) -> None:
    """Restore ``optimizer_state``'s output; a JAX checkpoint's optax state
    cannot be read here, and raises ``RunLifecycleError``."""
    if not isinstance(saved, dict) or saved.get("format") != OPTIMIZER_FORMAT:
        raise RunLifecycleError(
            "the resume checkpoint's optimizer state was not written by this trainer "
            f"(expected format {OPTIMIZER_FORMAT!r}; a JAX checkpoint holds optax state, "
            "which cannot be read here). Start a new run from its weights instead.")
    position = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group["params"])}
    index = {n: position[id(p)] for n, p in model.named_parameters() if id(p) in position}
    unknown = sorted(set(saved["state"]) - set(index))
    if unknown:
        raise RunLifecycleError(f"the optimizer state names unknown parameters: {unknown}")
    sd = optimizer.state_dict()
    sd["state"] = {index[n]: {k: torch.as_tensor(np.asarray(v)) for k, v in s.items()}
                   for n, s in saved["state"].items()}
    optimizer.load_state_dict(sd)


def checkpoint_cfg(cfg: dict) -> dict:
    """The config entries a checkpoint keeps (JSON-able values)."""
    return {k: v for k, v in cfg.items()
            if isinstance(v, (dict, str, int, float, bool, list, type(None)))}


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Every array of a dataset batch as a tensor on ``device`` (the raw
    ``sequence`` strings stay on the host)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()
            if k != "sequence"}


def start_model(kind: str, cfg, device: torch.device, *, seed: int, task_dims=None,
                init_tree: dict | None = None) -> torch.nn.Module:
    """A fresh model on ``device``: the JAX init's law drawn from ``seed``,
    or the JAX tree ``init_tree`` (a parity check hands JAX's own draw)."""
    from genomics_lm_torch.models import protein as pm
    from genomics_lm_torch.utils.weights import protein_module

    if init_tree is not None:
        return protein_params_from_jax(init_tree, kind, cfg, device).train()
    if kind == "multitask":
        model = pm.MultiTaskProteinCritic(cfg, task_dims)
    elif kind == "ebm":
        model = pm.ProteinLatentEBM(*cfg)
    else:
        model = protein_module(kind, cfg)
    return pm.init_weights(model, seed).to(device).train()


def load_frozen(payload: dict, kind: str, cfg, device: torch.device, key: str = "model"):
    """A checkpoint's model, frozen (``requires_grad=False``) on ``device``."""
    model = protein_params_from_jax(payload.get(key, payload), kind, cfg, device)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


__all__ = [
    "OPTIMIZER_FORMAT",
    "adamw",
    "apply_accumulated",
    "batch_to_device",
    "checkpoint_cfg",
    "load_frozen",
    "load_optimizer_state",
    "optimizer_state",
    "protein_params_to_jax",
    "resolve_device",
    "start_model",
]
