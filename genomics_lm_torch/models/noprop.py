"""NoProp codon LM: backprop-free layer-local denoising training (twin of
``genomics_lm_tpu/models/noprop.py``).

Each block receives the previous hidden state, detached, plus noisy target
embeddings and learns to denoise the targets through its own MSE head; the
tied LM head trains by cross-entropy on the final, detached state. One
forward with ``.detach()`` where JAX has ``stop_gradient`` gives every
parameter exactly its layer-local gradient, so one AdamW step over the
summed loss equals stepping a per-block AdamW on each block's own loss.

The blocks are the port's ``Block`` (LN, attention, LN, GELU MLP) with a
``denoise_head`` linear; attention is the einsum path, JAX's default
``impl="xla"`` here (``ops/attention.py:84``), and the model runs in
float32 as JAX's does. The noise comes from the caller's generator.
``params_to_jax`` / ``params_from_jax`` move the weights to and from the
JAX tree the checkpoints hold (``utils/weights.py``'s map plus
``blocks/denoise_head``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genomics_lm_torch.models.codon_gpt import Block, _layer_norm, _linear, _qkv
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.attention import attention
from genomics_lm_torch.ops.losses import cross_entropy
from genomics_lm_torch.ops.masks import segment_ids_from_tokens
from genomics_lm_torch.utils.weights import JaxLeaf, flatten_tree, jax_leaves


class NoPropGPT(nn.Module):
    """GPT blocks with per-block denoise heads, initialized with the JAX
    ``init`` distributions: N(0, 1) token and position embeddings,
    U(±1/√fan_in) linears, unit/zero layer norms."""

    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.n_embd
        self.tok_emb = nn.Embedding(cfg.vocab_size, D)
        self.pos_emb = nn.Embedding(cfg.block_size, D)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        for block in self.blocks:
            block.denoise_head = nn.Linear(D, D)
        self.ln_f = nn.LayerNorm(D)


def _block_apply(block: Block, x: torch.Tensor, cfg: CodonGPTConfig, segment_ids,
                 noisy_targets: torch.Tensor | None):
    if noisy_targets is not None:
        x = x + noisy_targets
    h = _layer_norm(block.ln1, x)
    q, k, v = _qkv(block, h, cfg)
    y = attention(q, k, v, segment_ids=segment_ids)
    B, T, C = x.shape
    x = x + _linear(block.attn.proj, y.transpose(1, 2).reshape(B, T, C))
    h2 = _layer_norm(block.ln2, x)
    x = x + _linear(block.mlp[2], F.gelu(_linear(block.mlp[0], h2)))
    return x, _linear(block.denoise_head, x)


def forward(model: NoPropGPT, cfg: CodonGPTConfig, idx: torch.Tensor,
            target_embeddings: torch.Tensor | None = None, *, layer_local: bool = False):
    """Returns (logits, per-block denoise predictions).

    ``layer_local=True`` detaches the input of every block after the first
    and the final state before the LM head (the NoProp training topology);
    False gives the inference forward.
    """
    T = idx.shape[1]
    x = model.tok_emb.weight[idx] + model.pos_emb.weight[:T][None]
    segment_ids = (
        segment_ids_from_tokens(idx, cfg.sep_id) if cfg.sep_id is not None else None
    )
    preds = []
    for layer, block in enumerate(model.blocks):
        if layer_local and layer > 0:
            x = x.detach()
        x, pred_y = _block_apply(block, x, cfg, segment_ids, target_embeddings)
        preds.append(pred_y)
    if layer_local:
        x = x.detach()
    h = _layer_norm(model.ln_f, x)
    logits = h @ model.tok_emb.weight.t()  # tied head
    return logits, preds


def noprop_loss(model: NoPropGPT, cfg: CodonGPTConfig, xb: torch.Tensor, yb: torch.Tensor,
                generator: torch.Generator | None, *, noise_sigma: float = 0.1):
    """Layer-local composite loss: Σ block denoise MSE + detached-head CE.
    The noise is ``noise_sigma`` x N(0, 1) from ``generator``."""
    y_clean = model.tok_emb.weight[yb].detach()
    noise = noise_sigma * torch.randn(y_clean.shape, generator=generator,
                                      device=y_clean.device)
    y_noisy = y_clean + noise
    nonpad = (yb != 0).float()[:, :, None]

    logits, preds = forward(model, cfg, xb, y_noisy, layer_local=True)
    denom = nonpad.sum().clamp_min(1.0)
    block_losses = [torch.sum(((pred - y_clean) ** 2) * nonpad) / denom for pred in preds]
    ce = cross_entropy(logits, yb, ignore_index=0)
    total = sum(block_losses) + ce
    return total, {"ce": ce, "block_mse": block_losses}


def noprop_leaves(model: NoPropGPT) -> list[JaxLeaf]:
    """The JAX tree's leaves: CodonGPT's map and each block's denoise head."""
    blocks = list(model.blocks)
    return jax_leaves(model, model.cfg) + [
        JaxLeaf("blocks/denoise_head/w", [(b.denoise_head.weight, None, True) for b in blocks],
                True),
        JaxLeaf("blocks/denoise_head/b", [(b.denoise_head.bias, None, False) for b in blocks],
                True),
    ]


def params_to_jax(model: NoPropGPT) -> dict:
    """The JAX parameter tree of ``model`` (nested dicts of float32 numpy)."""
    tree: dict = {}
    for leaf in noprop_leaves(model):
        node = tree
        *parents, name = leaf.path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf.gather().float().cpu().numpy().copy()
    return tree


def params_from_jax(tree: dict, cfg: CodonGPTConfig, device) -> NoPropGPT:
    """A ``NoPropGPT`` on ``device`` holding the JAX tree's weights; a leaf
    missing from the tree, one it has no place for or one of another shape
    raises."""
    model = NoPropGPT(cfg)
    flat = flatten_tree(tree)
    leaves = noprop_leaves(model)
    unused = sorted(set(flat) - {leaf.path for leaf in leaves})
    if unused:
        raise ValueError(f"the tree has leaves this config has no place for: {unused}")
    with torch.no_grad():
        for leaf in leaves:
            value = torch.from_numpy(np.array(flat[leaf.path], np.float32))
            if tuple(value.shape) != tuple(leaf.gather().shape):
                raise ValueError(f"the tree's {leaf.path} has shape {tuple(value.shape)}")
            leaf.write(lambda p: p.data, value)
    return model.to(device)


__all__ = ["NoPropGPT", "forward", "noprop_leaves", "noprop_loss", "params_from_jax",
           "params_to_jax"]
