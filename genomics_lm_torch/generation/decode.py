"""Autoregressive decoding over the KV cache (twin of ``genomics_lm_tpu/generation/decode.py``).

The cache is a dict of tensors: per-layer stacked keys/values in the
packed-lane layout (L, B, S, P) with ``P = Hkv * head_dim`` (see
``ops/decode_attention.py``), the per-position segment ids, the running
segment count, and the filled length (a Python int here; a device scalar
in JAX). ``prefill`` runs one full forward over the prompt and captures
every layer's K/V; ``decode_step`` then attends one new token against the
cache — through the CUDA decode-attention kernel when
``cfg.attention_impl == "flash"``, else through the plain path.

Where the JAX package donates the cache to XLA (``decode_step_donated``),
the port updates it in place: ``decode_step`` writes the new K/V row and
metadata into the cache it is given and returns that same dict.

Segment semantics: a cached decode attends only to positions with the same
<SEP> segment id, exactly the training-time mask, and positions use the
absolute index in the window, so cached and uncached paths agree while the
context fits in ``block_size`` (``next_token_logits`` is the uncached path).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from genomics_lm_torch.models.codon_gpt import (
    CodonGPT,
    _embed,
    _layer_norm,
    _linear,
    _lm_logits,
    _offset_logits,
    _qkv,
    apply_rope,
    block_epilogue,
    forward,
    rope_cos_sin,
    rotate_half,
)
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.attention import NEG_INF, attention
from genomics_lm_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from genomics_lm_torch.ops.masks import segment_ids_from_tokens
from genomics_lm_torch.ops.quant import quantize_kv
from genomics_lm_torch.utils.device import check_on_device, module_device, resolve_device

CACHE_BUCKET = 128  # cache sizes round up to multiples of this


def cache_bucket(cfg: CodonGPTConfig, horizon: int) -> int:
    """Smallest bucketed cache size covering ``horizon`` positions.

    Decode attention reads the whole cache every step, so a generation
    that never exceeds N positions carries an N-slot cache, not a
    block_size one."""
    rounded = ((max(1, int(horizon)) + CACHE_BUCKET - 1) // CACHE_BUCKET) * CACHE_BUCKET
    return min(cfg.block_size, rounded)


def init_cache(
    cfg: CodonGPTConfig,
    batch: int = 1,
    cache_size: int | None = None,
    kv_quant: bool = False,
    *,
    device: str | torch.device | None = None,
) -> dict:
    """Empty KV cache for ``batch`` sequences (``cache_size`` ≤ block_size).

    With ``kv_quant`` the cache stores int8 K/V plus per-vector float32
    scales (L, B, Hkv, S); the scales factor out of both attention
    contractions, so the int8 cache is read raw.
    """
    device = resolve_device(device)
    S = cfg.block_size if cache_size is None else int(cache_size)
    shape = (cfg.n_layer, batch, S, cfg.kv_heads * cfg.head_dim)
    kv_dtype = torch.int8 if kv_quant else cfg.dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "seg": torch.zeros((batch, S), dtype=torch.int32, device=device),
        "length": 0,
        "seg_count": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if kv_quant:
        scale_shape = (cfg.n_layer, batch, cfg.kv_heads, S)
        cache["k_scale"] = torch.zeros(scale_shape, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(scale_shape, dtype=torch.float32, device=device)
    return cache


def _aux_heads(model: CodonGPT, cfg: CodonGPTConfig, x: torch.Tensor) -> dict:
    aux = {}
    if cfg.termination_aux:
        aux["termination_logits"] = _linear(model.termination_head, x)
    for offset in cfg.multi_offset_targets:
        aux[f"offset_{offset}_logits"] = _offset_logits(model, cfg, x, offset)
    return aux


@torch.no_grad()
def prefill(model: CodonGPT, cfg: CodonGPTConfig, idx,
            cache_size: int | None = None,
            kv_quant: bool = False,
            last_index=None,
            want_aux: bool = True,
            *,
            device: str | torch.device | None = None) -> tuple[torch.Tensor, dict, dict]:
    """Full forward over the prompt, returning (last logits, cache, aux).

    Prompt attention always runs full precision on the plain path (as in
    JAX: at admission shapes the materialized scores are small); with
    ``kv_quant`` the K/V written into the cache are int8 + per-vector
    scales. ``last_index`` (scalar or (B,)) gathers the returned logits/aux
    at that position instead of the final one — right-padded prompts read
    their true last token while causality keeps the pads from influencing
    it. A scalar also sets the cache length to ``last_index + 1``; a (B,)
    index leaves per-row ends to ragged consumers (the serving engine).
    """
    device = resolve_device(device)
    check_on_device(model, device)
    idx = torch.as_tensor(idx, dtype=torch.long).to(device)
    B, T = idx.shape
    cache = init_cache(cfg, B, cache_size, kv_quant, device=device)
    S = cache["seg"].shape[1]
    if T > S:
        raise ValueError(f"prompt length {T} exceeds the cache size {S}")
    if cfg.sep_id is not None:
        seg = segment_ids_from_tokens(idx, cfg.sep_id)
    else:
        seg = torch.zeros((B, T), dtype=torch.int32, device=device)

    x = _embed(model, cfg, idx)
    rope = (rope_cos_sin(T, cfg.head_dim, cfg.rope_base, cfg.dtype, device)
            if cfg.use_rope else None)
    ks, vs = [], []
    for block in model.blocks:
        h = _layer_norm(block.ln1, x)
        q, k, v = _qkv(block, h, cfg)
        if rope is not None:
            q, k = apply_rope(q, k, *rope)
        ks.append(k)
        vs.append(v)
        y = attention(q, k, v, segment_ids=seg if cfg.sep_id is not None else None)
        x = block_epilogue(block, cfg, x, y.transpose(1, 2).reshape(B, T, cfg.n_embd))

    x = _layer_norm(model.ln_f, x)
    logits = _lm_logits(model, cfg, x)
    aux = _aux_heads(model, cfg, x) if want_aux else {}

    k_stack, v_stack = torch.stack(ks), torch.stack(vs)  # (L, B, Hkv, T, D)
    if kv_quant:
        k_stack, k_scale = quantize_kv(k_stack)
        v_stack, v_scale = quantize_kv(v_stack)
        cache["k_scale"][:, :, :, :T] = k_scale
        cache["v_scale"][:, :, :, :T] = v_scale
    L = k_stack.shape[0]
    cache["k"][:, :, :T] = k_stack.permute(0, 1, 3, 2, 4).reshape(L, B, T, -1)
    cache["v"][:, :, :T] = v_stack.permute(0, 1, 3, 2, 4).reshape(L, B, T, -1)
    cache["seg"][:, :T] = seg
    cache["length"] = T
    if last_index is None:
        last = torch.full((B,), T - 1, dtype=torch.long, device=device)
    elif (last_index.dim() if torch.is_tensor(last_index) else np.ndim(last_index)) == 0:
        # uniform right-padding: the cache ends at the true last token, so
        # a following decode_step overwrites the pad K/V instead of
        # attending them
        cache["length"] = int(last_index) + 1
        last = torch.full((B,), int(last_index), dtype=torch.long, device=device)
    else:
        last = torch.as_tensor(last_index, dtype=torch.long).to(device)
    rows = torch.arange(B, device=device)
    take = lambda a: a[rows, last]  # noqa: E731
    cache["seg_count"] = take(seg)
    return take(logits), cache, {k: take(v) for k, v in aux.items()}


def _decode_mask(cache_seg, seg_now, filled, write_pos, sep_id) -> torch.Tensor:
    """One additive float32 (B, S) mask row shared by every layer.

    A slot attends cached positions below ``filled`` in its current
    segment, and always its own write position. It stays float32 even for
    a bf16 model: NEG_INF overflows to -inf in bf16.
    """
    S = cache_seg.shape[1]
    positions = torch.arange(S, device=cache_seg.device)[None, :]
    valid = positions < filled
    if sep_id is not None:
        valid = valid & (cache_seg == seg_now[:, None])
    valid = valid | (positions == write_pos)
    mask = torch.zeros(valid.shape, dtype=torch.float32, device=cache_seg.device)
    return mask.masked_fill_(~valid, NEG_INF)


def _attend(cfg: CodonGPTConfig, q_flat, cache: dict, mask_add, layer: int):
    """Decode attention for one layer: ``decode_attention`` (the CUDA kernel
    for CUDA tensors) under ``flash``, else the plain version."""
    ks = cache.get("k_scale")
    vs = cache.get("v_scale")
    q_flat = q_flat.contiguous()  # a fused-QKV query is a strided slice
    if cfg.attention_impl == "flash":
        return decode_attention(q_flat, cache["k"], cache["v"], mask_add, layer,
                                ks, vs, kv_heads=cfg.kv_heads)
    return decode_attention_reference(q_flat, cache["k"], cache["v"], mask_add, layer,
                                      ks, vs, compute_dtype=cfg.dtype,
                                      kv_heads=cfg.kv_heads)


def _decode_layers(model: CodonGPT, cfg: CodonGPTConfig, cache: dict,
                   token: torch.Tensor, positions: torch.Tensor,
                   write_pos: torch.Tensor, mask_add: torch.Tensor) -> torch.Tensor:
    """The layer stack of one cached decode step; returns the hidden state
    (B, 1, C) after the final layer norm.

    ``token`` (B,) is embedded at ``positions`` (B,); every sequence writes
    its K/V row (and int8 scales) at its own ``write_pos`` (B,) in place.
    ``decode_step`` passes one shared length; the serving engine's ragged
    step passes per-slot lengths.
    """
    B = token.shape[0]
    x = F.embedding(token, model.tok_emb.weight).to(cfg.dtype)[:, None, :]
    if cfg.use_rope:
        cos_full, sin_full = rope_cos_sin(
            cfg.block_size, cfg.head_dim, cfg.rope_base, cfg.dtype, token.device)
        cos = cos_full[positions][:, None, None, :]  # (B, 1, 1, D)
        sin = sin_full[positions][:, None, None, :]
    else:
        x = x + model.pos_emb.weight[positions].to(cfg.dtype)[:, None, :]
    bidx = torch.arange(B, device=token.device)
    kv_quant = "k_scale" in cache
    for layer, block in enumerate(model.blocks):
        h = _layer_norm(block.ln1, x)
        q, k, v = _qkv(block, h, cfg)  # (B, H, 1, D), (B, Hkv, 1, D)
        if cfg.use_rope:
            q = q * cos + rotate_half(q) * sin
            k = k * cos + rotate_half(k) * sin
        if kv_quant:
            k, k_sc = quantize_kv(k)  # int8 (B, Hkv, 1, D), f32 (B, Hkv, 1)
            v, v_sc = quantize_kv(v)
            cache["k_scale"][layer, bidx, :, write_pos] = k_sc[:, :, 0]
            cache["v_scale"][layer, bidx, :, write_pos] = v_sc[:, :, 0]
        # one contiguous packed (B, P) row per layer
        cache["k"][layer, bidx, write_pos] = k[:, :, 0, :].reshape(B, -1).to(cache["k"].dtype)
        cache["v"][layer, bidx, write_pos] = v[:, :, 0, :].reshape(B, -1).to(cache["v"].dtype)
        y = _attend(cfg, q.reshape(B, cfg.n_head, cfg.head_dim), cache, mask_add, layer)
        x = block_epilogue(block, cfg, x, y.to(cfg.dtype).reshape(B, 1, cfg.n_embd))
    return _layer_norm(model.ln_f, x)


@torch.no_grad()
def decode_step(model: CodonGPT, cfg: CodonGPTConfig, cache: dict, token):
    """Append one token per sequence; returns (logits, cache, aux).

    ``token``: (B,) ids. Attention masks cached positions by segment id
    and validity (pos < length); the new token always attends to itself.
    Updates ``cache`` in place (JAX's donated variant) and returns it.
    """
    device = cache["k"].device
    token = torch.as_tensor(token, dtype=torch.long).to(device)
    B = token.shape[0]
    length = int(cache["length"])
    S = cache["seg"].shape[1]
    if length >= S:
        raise ValueError(f"cache is full ({S} positions)")
    new_seg = cache["seg_count"]
    if cfg.sep_id is not None:
        new_seg = new_seg + (token == cfg.sep_id).to(torch.int32)

    mask_add = _decode_mask(cache["seg"], new_seg, length, length, cfg.sep_id)
    positions = torch.full((B,), length, dtype=torch.long, device=device)
    x = _decode_layers(model, cfg, cache, token, positions, positions, mask_add)
    logits = _lm_logits(model, cfg, x)[:, 0]
    aux = {k: v[:, 0] for k, v in _aux_heads(model, cfg, x).items()}
    cache["seg"][:, length] = new_seg
    cache["length"] = length + 1
    cache["seg_count"] = new_seg
    return logits, cache, aux


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick.

    The same construction as ``jax.random.categorical``; the draws differ
    from JAX's (another generator), the distribution does not. As in
    ``jax.random.gumbel`` the uniforms lie in [tiny, 1), so the Gumbel
    noise is finite and a row of log-probabilities that is -inf off one
    entry (a one-hot) always returns that entry. No host sync.
    """
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min_(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def generate_tokens(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    prompt,
    n_tokens: int,
    generator: torch.Generator | None = None,
    temperature: float = 1.0,
    kv_quant: bool = False,
    *,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Batched sampling: ``prefill`` then ``n_tokens`` cached decode steps.

    ``prompt``: (B, P) ids. Categorical sampling at ``temperature`` from
    ``generator`` (greedy when ``temperature <= 0``). Returns (B, n_tokens)
    ids. The cache is bucketed to the generation horizon, as in JAX; a
    Python loop replaces the JAX ``lax.scan``.
    """
    return _generate(model, cfg, prompt, n_tokens, generator, temperature, kv_quant,
                     None, device)


@torch.no_grad()
def generate_masked_tokens(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    prompt,
    n_tokens: int,
    generator: torch.Generator | None,
    temperature: float,
    allowed_mask,
    kv_quant: bool = False,
    *,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """``generate_tokens`` with a vocabulary mask applied at every step.

    ``allowed_mask``: (V,) bool (e.g. the CDS codon set); sampling, or the
    greedy argmax when ``temperature <= 0``, is restricted to allowed ids.
    Twin of the JAX ``generate_masked_tokens``. Returns (B, n_tokens) ids.
    """
    return _generate(model, cfg, prompt, n_tokens, generator, temperature, kv_quant,
                     allowed_mask, device)


def _generate(model, cfg, prompt, n_tokens, generator, temperature, kv_quant,
              allowed_mask, device) -> torch.Tensor:
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(device)
    horizon = prompt.shape[1] + int(n_tokens)
    if horizon > cfg.block_size:
        raise ValueError(
            f"prompt+n_tokens {horizon} exceeds block_size {cfg.block_size}")
    logits, cache, _ = prefill(model, cfg, prompt, cache_bucket(cfg, horizon),
                               kv_quant, want_aux=False, device=device)
    blocked = (None if allowed_mask is None
               else ~torch.as_tensor(allowed_mask, dtype=torch.bool).to(device))
    tokens = []
    for i in range(int(n_tokens)):
        if blocked is not None:
            logits = logits.float().masked_fill(blocked[None, :], NEG_INF)
        if temperature <= 0:
            token = torch.argmax(logits, dim=-1)
        else:
            token = sample_categorical(logits.float() / temperature, generator)
        tokens.append(token)
        if i + 1 < n_tokens:
            logits, cache, _ = decode_step(model, cfg, cache, token)
    return torch.stack(tokens, dim=1)


class CachedDecoder:
    """Host-side wrapper maintaining a single-sequence cache on the model's device.

    Falls back to clip-and-recompute (reference semantics) once the
    context exceeds ``block_size``.
    """

    def __init__(self, model: CodonGPT, cfg: CodonGPTConfig):
        self.model = model
        self.cfg = cfg
        self.device = module_device(model)
        self.ids: list[int] = []
        self._cache = None

    def next_logits(self, ids: list[int], return_aux: bool = False):
        """Logits for the next token after ``ids`` (uses the cache when
        ``ids`` extends the previous call by exactly one token)."""
        cfg = self.cfg
        if len(ids) > cfg.block_size:
            out = next_token_logits(self.model, cfg, ids, return_aux=return_aux)
            self.ids = list(ids)
            self._cache = None
            return out
        if (
            self._cache is not None
            and len(ids) == len(self.ids) + 1
            and ids[: len(self.ids)] == self.ids
            and self._cache["length"] < self._cache["seg"].shape[1]
        ):
            logits, self._cache, aux = decode_step(
                self.model, cfg, self._cache, [ids[-1]])
        else:
            logits, self._cache, aux = prefill(
                self.model, cfg, [ids], device=self.device)
        self.ids = list(ids)
        out = logits[0].float().cpu().numpy()
        if return_aux:
            return out, {k: v[0].float().cpu().numpy() for k, v in aux.items()}
        return out


@torch.no_grad()
def next_token_logits(model: CodonGPT, cfg: CodonGPTConfig, ids,
                      return_aux: bool = False):
    """Uncached reference path: full forward over the clipped context."""
    ctx = list(ids)[-cfg.block_size:]
    x = torch.as_tensor([ctx], dtype=torch.long, device=module_device(model))
    logits, _, aux = forward(model, cfg, x, return_aux=True)
    flat_aux = {}
    if "termination_logits" in aux:
        flat_aux["termination_logits"] = aux["termination_logits"][0, -1].float().cpu().numpy()
    for offset, ol in aux.get("offset_logits", {}).items():
        flat_aux[f"offset_{offset}_logits"] = ol[0].float().cpu().numpy()
    last = logits[0, -1].float().cpu().numpy()
    return (last, flat_aux) if return_aux else last


def sample_token(
    logits: np.ndarray, temperature: float, topk: int, rng: np.random.Generator
) -> int:
    """Temperature + top-k multinomial sampling (parity: generate.py:51-59)."""
    logits = np.asarray(logits, dtype=np.float64)
    if temperature != 1.0:
        logits = logits / max(1e-6, float(temperature))
    logits = logits - logits.max()
    probs = np.exp(logits)
    probs = probs / probs.sum()
    if topk and topk > 0:
        k = min(int(topk), probs.size)
        idxs = np.argpartition(probs, -k)[-k:]
        vals = probs[idxs]
        vals = vals / vals.sum()
        return int(rng.choice(idxs, p=vals))
    return int(rng.choice(probs.size, p=probs))


__all__ = [
    "CACHE_BUCKET",
    "CachedDecoder",
    "cache_bucket",
    "decode_step",
    "generate_masked_tokens",
    "generate_tokens",
    "init_cache",
    "next_token_logits",
    "prefill",
    "sample_categorical",
    "sample_token",
]
