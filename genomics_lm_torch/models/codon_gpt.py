"""CodonGPT forward (twin of ``genomics_lm_tpu/models/codon_gpt.py``).

The JAX model is a set of pure functions over a parameter pytree with the
per-layer weights stacked on a leading L axis. Here the weights live in an
``nn.Module`` whose ``state_dict`` keys follow the reference ``TinyGPT``
layout (``utils/weights.py`` documents the map), and the forward pieces
stay plain functions with the JAX names — ``_embed``, ``_layer_norm``,
``_qkv``, ``block_epilogue``, ``_lm_logits``, ``forward`` — taking the
module where the JAX code takes the parameter tree. Cached decode and
serving (``generation/decode.py``, ``serving/engine.py``) reuse them.

Numerics follow the JAX code: parameters stay float32 and are cast to
``cfg.dtype`` at each use, activations run in ``cfg.dtype``, layer norm and
the attention softmax run in float32.

Covered: learned positions or RoPE, GELU or SwiGLU MLP, MHA or GQA, fused
or separate QKV, tied or untied LM head, the termination and multi-offset
auxiliary heads, shape guidance, and training: the cross-entropy loss and
dropout. Embedding and MLP-output dropout are plain draws from the
caller's ``torch.Generator``; attention dropout runs inside the attention
op (the flash kernels on the card) from a seed drawn from the same
generator. Attention follows ``cfg.attention_impl``. Not ported: the MoE
MLP, LoRA and weight-only int8 linears (building or loading such a model
raises ``NotImplementedError``); remat (``use_checkpoint``) is refused by
``training/train_step.py``, since it changes only the training memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.attention import attention
from genomics_lm_torch.ops.losses import cross_entropy
from genomics_lm_torch.ops.masks import segment_ids_from_tokens


class _Attention(nn.Module):
    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        D = cfg.n_embd
        kv_dim = cfg.kv_heads * cfg.head_dim
        if cfg.fused_qkv:
            # one (C, Cq + 2·Ckv) linear: query | key | value along the output
            self.qkv = nn.Linear(D, D + 2 * kv_dim)
        else:
            self.query = nn.Linear(D, D)
            self.key = nn.Linear(D, kv_dim)
            self.value = nn.Linear(D, kv_dim)
        self.proj = nn.Linear(D, D)


class _SwiGLU(nn.Module):
    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        D, H = cfg.n_embd, cfg.mlp_hidden
        self.w_gate = nn.Linear(D, H, bias=False)
        self.w_up = nn.Linear(D, H, bias=False)
        self.w_down = nn.Linear(H, D, bias=False)


def _gelu_mlp(d_in: int, hidden: int, d_out: int) -> nn.Sequential:
    # Sequential so the state_dict keys are mlp.0 / mlp.2 as in the reference
    return nn.Sequential(nn.Linear(d_in, hidden), nn.GELU(), nn.Linear(hidden, d_out))


class Block(nn.Module):
    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        D = cfg.n_embd
        self.ln1 = nn.LayerNorm(D)
        self.attn = _Attention(cfg)
        self.ln2 = nn.LayerNorm(D)
        self.mlp = _SwiGLU(cfg) if cfg.use_swiglu else _gelu_mlp(D, cfg.mlp_hidden, D)


class CodonGPT(nn.Module):
    """Parameters of one CodonGPT, initialized with the JAX ``init`` distributions.

    torch's defaults already match them: U(±1/√fan_in) for linear weights
    and biases, N(0, 1) embeddings, unit/zero layer norms. The offset heads
    start as identities and shape guidance as a no-op, as in JAX.
    """

    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError("MoE MLP (moe_experts > 0) is not ported")
        self.cfg = cfg
        D = cfg.n_embd
        self.tok_emb = nn.Embedding(cfg.vocab_size, D)
        if not cfg.use_rope:
            self.pos_emb = nn.Embedding(cfg.block_size, D)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(D)
        if not cfg.tie_embeddings:
            self.head = nn.Linear(D, cfg.vocab_size, bias=False)
        if cfg.termination_aux:
            self.termination_head = nn.Linear(D, cfg.termination_n_classes)
        if cfg.use_shape_guidance:
            self.shape_proj = nn.Linear(3, D)
            nn.init.zeros_(self.shape_proj.weight)
            nn.init.zeros_(self.shape_proj.bias)
        if cfg.multi_offset_targets:
            self.offset_projs = nn.ModuleDict(
                {str(o): _gelu_mlp(D, D, D) for o in cfg.multi_offset_targets})
            for mlp in self.offset_projs.values():
                for lin in (mlp[0], mlp[2]):
                    nn.init.eye_(lin.weight)
                    nn.init.zeros_(lin.bias)

    def forward(self, idx: torch.Tensor, targets: torch.Tensor | None = None, *,
                train: bool = False, generator: torch.Generator | None = None,
                return_aux: bool = False,
                shape_embeddings: torch.Tensor | None = None,
                attention_window: int | None = None):
        return forward(self, self.cfg, idx, targets, train=train, generator=generator,
                       return_aux=return_aux, shape_embeddings=shape_embeddings,
                       attention_window=attention_window)


# --- Forward pieces ----------------------------------------------------------


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` in x's dtype, with the float32 weights cast at use."""
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # statistics and affine in f32, then back to the activation dtype
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, eps)
    return y.to(x.dtype)


def rope_cos_sin(T: int, head_dim: int, base: float, dtype: torch.dtype,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin caches in the duplicated-halves layout: emb = concat(freqs, freqs)."""
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                 / head_dim))
    t = torch.arange(T, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """cos/sin: (T, head_dim) → broadcast over (B, H, T, D)."""
    cos = cos[None, None, :, :]
    sin = sin[None, None, :, :]
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def _qkv(block: Block, x: torch.Tensor, cfg: CodonGPTConfig):
    """(B, T, C) → q (B, Hq, T, D), k and v (B, Hkv, T, D)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    attn = block.attn
    if hasattr(attn, "qkv"):
        c_q = cfg.n_head * hd
        c_kv = cfg.kv_heads * hd
        q, k, v = torch.split(_linear(attn.qkv, x), [c_q, c_kv, c_kv], dim=-1)
    else:
        q, k, v = _linear(attn.query, x), _linear(attn.key, x), _linear(attn.value, x)
    q = q.reshape(B, T, cfg.n_head, hd).transpose(1, 2)
    k = k.reshape(B, T, cfg.kv_heads, hd).transpose(1, 2)
    v = v.reshape(B, T, cfg.kv_heads, hd).transpose(1, 2)
    return q, k, v


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator`` (JAX:
    ``bernoulli(1 - rate)``, kept values scaled by 1/(1 - rate))."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _dropout_on(cfg: CodonGPTConfig, train: bool, generator) -> bool:
    return train and generator is not None and cfg.dropout > 0.0


def block_epilogue(block: Block, cfg: CodonGPTConfig, x: torch.Tensor,
                   y_attn: torch.Tensor, *, train: bool = False,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Post-attention half of a block, shared by every path: the output
    projection's residual add, LN2, and the (SwiGLU | GELU) MLP residual,
    whose output takes dropout in training."""
    x = x + _linear(block.attn.proj, y_attn)
    h = _layer_norm(block.ln2, x)
    mlp = block.mlp
    if cfg.use_swiglu:
        m = _linear(mlp.w_down, F.silu(_linear(mlp.w_gate, h)) * _linear(mlp.w_up, h))
    else:
        m = _linear(mlp[2], F.gelu(_linear(mlp[0], h)))
    if _dropout_on(cfg, train, generator):
        m = _dropout(m, cfg.dropout, generator)
    return x + m


def _embed(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor,
           shape_embeddings: torch.Tensor | None = None, *, train: bool = False,
           generator: torch.Generator | None = None) -> torch.Tensor:
    x = F.embedding(idx, model.tok_emb.weight).to(cfg.dtype)
    if not cfg.use_rope:
        T = idx.shape[1]
        x = x + model.pos_emb.weight[:T].to(cfg.dtype)[None, :, :]
    if shape_embeddings is not None and cfg.use_shape_guidance:
        x = x + _linear(model.shape_proj, shape_embeddings.to(cfg.dtype))
    if _dropout_on(cfg, train, generator):
        x = _dropout(x, cfg.dropout, generator)
    return x


def _lm_logits(model: CodonGPT, cfg: CodonGPTConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, model.tok_emb.weight.to(x.dtype).t())
    return _linear(model.head, x)


def _offset_logits(model: CodonGPT, cfg: CodonGPTConfig, x: torch.Tensor, offset: int):
    mlp = model.offset_projs[str(offset)]
    return _lm_logits(model, cfg, _linear(mlp[2], F.gelu(_linear(mlp[0], x))))


def forward(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    idx: torch.Tensor,
    targets: torch.Tensor | None = None,
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    return_aux: bool = False,
    shape_embeddings: torch.Tensor | None = None,
    attention_window: int | None = None,
):
    """Full forward pass. Returns ``(logits, loss)`` or, with ``return_aux``,
    ``(logits, loss, aux)``; aux carries ``termination_logits`` and
    ``offset_logits`` ({offset: logits}) when those heads exist, as the JAX
    ``forward`` does. ``loss`` is the torch-semantics cross-entropy against
    ``targets`` (pad id 0 ignored, ``cfg.label_smoothing`` and
    ``cfg.loss_weights``), or None without targets.

    Dropout acts only with ``train`` and a ``generator`` on idx's device,
    as the JAX forward drops only with ``train`` and a key. Runs under
    autograd: the serving and generation entry points call it under
    ``torch.no_grad``.
    """
    segment_ids = (
        segment_ids_from_tokens(idx, cfg.sep_id) if cfg.sep_id is not None else None
    )
    drop = _dropout_on(cfg, train, generator)
    x = _embed(model, cfg, idx, shape_embeddings, train=drop, generator=generator)
    rope = (
        rope_cos_sin(idx.shape[1], cfg.head_dim, cfg.rope_base, cfg.dtype, idx.device)
        if cfg.use_rope else None
    )
    B, T, C = x.shape
    for block in model.blocks:
        h = _layer_norm(block.ln1, x)
        q, k, v = _qkv(block, h, cfg)
        if rope is not None:
            q, k = apply_rope(q, k, *rope)
        seed = (torch.randint(0, 2**31 - 1, (1,), generator=generator, device=idx.device,
                              dtype=torch.int32) if drop else None)
        y = attention(q, k, v, segment_ids=segment_ids,
                      attention_window=attention_window,
                      dropout_rate=cfg.dropout if drop else 0.0, seed=seed,
                      impl=cfg.attention_impl)
        x = block_epilogue(block, cfg, x, y.transpose(1, 2).reshape(B, T, C),
                           train=drop, generator=generator)
    x = _layer_norm(model.ln_f, x)
    logits = _lm_logits(model, cfg, x)

    loss = None
    if targets is not None:
        weight = (None if cfg.uniform_loss_weights
                  else torch.tensor(cfg.loss_weights, dtype=torch.float32,
                                    device=logits.device))
        loss = cross_entropy(logits, targets, ignore_index=0,
                             label_smoothing=cfg.label_smoothing, weight=weight)
    if not return_aux:
        return logits, loss
    aux: dict = {}
    if cfg.termination_aux:
        aux["termination_logits"] = _linear(model.termination_head, x)
    if cfg.multi_offset_targets:
        aux["offset_logits"] = {
            o: _offset_logits(model, cfg, x, o) for o in cfg.multi_offset_targets}
    return logits, loss, aux


__all__ = [
    "Block",
    "CodonGPT",
    "apply_rope",
    "block_epilogue",
    "forward",
    "rope_cos_sin",
    "rotate_half",
]
