"""Speculative decoding: bigram-draft proposals + chunked target verify.

Twin of ``genomics_lm_tpu/serving/speculative.py``. Decode is bound by
reading the KV cache every step; verifying K drafted tokens in ONE chunk
forward reads the cache once for all of them, so accepted drafts are
almost free, and the output distribution is unchanged (the Leviathan et
al. / Chen et al. rejection-sampling scheme). The draft model is a
smoothed 68×68 bigram table over the codon vocabulary.

One speculative round (``_speculative_round``):

    1. sample t0 from the pending next-token distribution
    2. chain K draft tokens d1..dK from the bigram table
    3. ONE ragged chunk forward verifies [t0, d1..dK] against the cache
       (per-slot positions, so it composes with continuous batching); its
       attention is ``ops.decode_attention.decode_attention_chunk``, the
       hand-written CUDA kernel for CUDA tensors, under ``flash``
    4. per-slot rejection sampling: accept the longest prefix, emit
       1 + m tokens; the next pending distribution is the residual
       norm(max(p − q, 0)) on rejection or the bonus row p_K when all K
       were accepted

Per-slot sampling params (temperature / top-k / top-p, greedy ≤ 0) are
applied to the target rows before acceptance, so each emitted token is
drawn from exactly the distribution the plain path samples from; greedy
requests emit the tokens of ``generate_tokens``.

The cache is written optimistically for all K+1 chunk rows; rejected rows
sit above the committed ``lengths``, are masked out and overwritten by the
next round, so active slots need K+1 positions of headroom
(``ServingEngine`` allocates it). JAX's ``lax.scan``/``while_loop`` become
Python loops over device tensors; the caches and segment ids are updated
in place where JAX donates them. Every random draw comes from the
caller's ``torch.Generator``, so sampled draws differ from JAX's while
their distribution does not.

Under tensor parallelism (a ``ServingEngine`` with a mesh) each rank
verifies on its local heads through the same chunk kernel (JAX's mesh
verify takes the einsum path; the kernel is the same function, and the
plain version stays off the card's path), and every rank takes rank 0's
drafts and verify logits, so all of them accept the same tokens.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from genomics_lm_torch.generation.decode import (
    CACHE_BUCKET,
    prefill,
    sample_categorical,
)
from genomics_lm_torch.models.codon_gpt import (
    CodonGPT,
    _layer_norm,
    _lm_logits,
    _qkv,
    block_epilogue,
    rope_cos_sin,
    rotate_half,
)
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.attention import NEG_INF
from genomics_lm_torch.ops.decode_attention import (
    decode_attention_chunk,
    decode_attention_chunk_reference,
)
from genomics_lm_torch.ops.quant import quantize_kv
from genomics_lm_torch.parallel import tensor_parallel as tpl
from genomics_lm_torch.serving.engine import filtered_sampling_logits
from genomics_lm_torch.utils.device import check_on_device, resolve_device


def fit_bigram_table(stream, vocab_size: int, alpha: float = 0.5,
                     exclude_ids: tuple = ()) -> np.ndarray:
    """(V, V) draft table: add-``alpha`` smoothed P(next | prev) from a token stream.

    ``stream``: one 1-D int sequence, a 2-D (N, T) array of N sequences, or
    a list of sequences. Smoothing keeps every row strictly positive.
    ``exclude_ids`` drops transitions into or out of the named tokens (pass
    ``(0,)`` for padded windows).
    """
    counts = np.full((vocab_size, vocab_size), float(alpha), np.float64)
    if isinstance(stream, (list, tuple)):
        seqs = stream
    else:
        arr = np.asarray(stream)
        # a 2-D window array is N sequences: raveling it would invent a
        # last-token -> first-token transition per row
        seqs = list(arr) if arr.ndim == 2 else [arr]
    for s in seqs:
        s = np.asarray(s, np.int64).ravel()
        if s.size < 2:
            continue
        prev, nxt = s[:-1], s[1:]
        if exclude_ids:
            keep = ~(np.isin(prev, exclude_ids) | np.isin(nxt, exclude_ids))
            prev, nxt = prev[keep], nxt[keep]
        np.add.at(counts, (prev, nxt), 1.0)
    return (counts / counts.sum(axis=1, keepdims=True)).astype(np.float32)


def restrict_table(table: np.ndarray, allowed: np.ndarray,
                   floor: float = 1e-6) -> np.ndarray:
    """Mask draft-table columns to an allowed-token set and renormalize.

    A draft the sampler can never emit is always rejected; restricting q
    to the allowed set keeps the scheme exact (the target rows are masked
    the same way) and lifts acceptance. ``floor`` keeps allowed columns
    strictly positive.
    """
    t = np.where(allowed[None, :], np.maximum(table, floor), 0.0)
    return (t / t.sum(axis=1, keepdims=True)).astype(np.float32)


def _slot_probs(logits: torch.Tensor, sampling: dict,
                allowed_mask: torch.Tensor | None,
                use_filters: bool = True) -> torch.Tensor:
    """Per-slot transformed next-token distribution, as probabilities.

    The plain sampler's filter chain (``engine.filtered_sampling_logits``:
    allowed mask → temperature → top-k → top-p), then softmax; greedy slots
    (temperature ≤ 0) become an exact one-hot of the argmax, so greedy
    acceptance is deterministic. logits (B, V) raw f32; returns (B, V) f32.
    """
    greedy_tok, scaled = filtered_sampling_logits(
        logits, sampling, allowed_mask, use_filters)
    greedy = F.one_hot(greedy_tok, logits.shape[-1]).float()
    probs = torch.softmax(scaled, dim=-1)
    return torch.where((sampling["temps"] <= 0)[:, None], greedy, probs)


def _chunk_probs(logits: torch.Tensor, sampling: dict,
                 allowed_mask: torch.Tensor | None, use_filters: bool) -> torch.Tensor:
    """``_slot_probs`` of every row of (B, T, V) logits, with slot b's sampling
    params on each of its T rows (JAX: a ``vmap`` over the chunk axis)."""
    B, T, V = logits.shape
    per_row = {key: val.repeat_interleave(T) for key, val in sampling.items()}
    return _slot_probs(logits.reshape(B * T, V), per_row, allowed_mask,
                       use_filters).reshape(B, T, V)


def speculative_acceptance(P: torch.Tensor, Q: torch.Tensor,
                           drafts: torch.Tensor, uniforms: torch.Tensor):
    """Vectorized rejection sampling over one verification chunk.

    P: (B, K+1, V) target probabilities (row i is the distribution after
    [t0, d1..d_i]; row K is the bonus row). Q: (B, K, V) draft
    distributions that proposed d1..dK. drafts: (B, K) ids; uniforms:
    (B, K) in [0, 1).

    Returns (m, next_probs): ``m`` (B,) accepted drafts (the longest
    accepted prefix), ``next_probs`` (B, V) the distribution of the next
    emitted token: the residual norm(max(P_m − Q_m, 0)) at the first
    rejection, or the bonus row P_K when all K were accepted. Acceptance is
    u·q < p (no division; q = 0 is safe).
    """
    K = Q.shape[1]
    V = P.shape[-1]
    idx = drafts.long()[:, :, None]
    q_d = torch.gather(Q, 2, idx)[..., 0]
    p_d = torch.gather(P[:, :K], 2, idx)[..., 0]
    accept = uniforms * q_d < p_d
    m = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # (B,) in [0, K]
    P_m = torch.gather(P, 1, m[:, None, None].expand(-1, 1, V))[:, 0]
    Q_m = torch.gather(Q, 1, m.clamp_max(K - 1)[:, None, None].expand(-1, 1, V))[:, 0]
    res = (P_m - Q_m).clamp_min(0.0)
    mass = res.sum(dim=-1, keepdim=True)
    # zero residual mass means P == Q, which cannot reject; guard float edges
    res = torch.where(mass > 0, res / mass.clamp_min(1e-20), P_m)
    next_probs = torch.where((m == K)[:, None], P_m, res)
    return m, next_probs


def _attend_chunk(cfg: CodonGPTConfig, q, state: dict, mask_add, layer: int):
    """Chunk attention for one layer: ``decode_attention_chunk`` (the CUDA
    kernel for CUDA tensors) under ``flash``, else the plain version."""
    ks = state.get("k_scale")
    vs = state.get("v_scale")
    q = q.contiguous()  # a fused-QKV query is a strided slice
    if cfg.attention_impl == "flash":
        return decode_attention_chunk(q, state["k"], state["v"], mask_add, layer,
                                      ks, vs, kv_heads=cfg.kv_heads)
    return decode_attention_chunk_reference(q, state["k"], state["v"], mask_add, layer,
                                            ks, vs, compute_dtype=cfg.dtype,
                                            kv_heads=cfg.kv_heads)


def verify_mask(seg: torch.Tensor, lengths: torch.Tensor, chunk_seg: torch.Tensor,
                wpos: torch.Tensor) -> torch.Tensor:
    """The verify chunk's (B, T, S) additive float32 mask.

    Row t may attend every position below ``length + t + 1`` (the cache plus
    chunk rows 0..t) whose segment id (``seg``, (B, S), the chunk's ids
    already written) is its own (``chunk_seg``, (B, T)), and always its own
    slot ``wpos`` (B, T).
    """
    B, T = chunk_seg.shape
    S = seg.shape[1]
    dev = seg.device
    positions = torch.arange(S, device=dev)
    offs = torch.arange(T, device=dev)
    avail = positions[None, None, :] < (lengths[:, None] + offs[None, :] + 1)[:, :, None]
    seg_ok = seg[:, None, :] == chunk_seg[:, :, None]
    self_pos = positions[None, None, :] == wpos[:, :, None]
    valid = (avail & seg_ok) | self_pos
    mask_add = torch.zeros(valid.shape, dtype=torch.float32, device=dev)
    return mask_add.masked_fill_(~valid, NEG_INF)


@torch.no_grad()
def _ragged_verify(model: CodonGPT, cfg: CodonGPTConfig, state: dict,
                   tokens: torch.Tensor):
    """One chunk forward: append T tokens per slot, logits at every row.

    The multi-token form of ``engine._ragged_decode``: each slot writes
    its T K/V rows (and int8 scales) at positions ``min(length + t, S-1)``
    and its chunk's segment ids (a frozen inactive slot keeps its old ids),
    all in place. Row t attends every position below ``length + t + 1`` in
    its own segment, plus its own slot, through a (B, T, S) mask.

    Returns (logits (B, T, V) f32, the updated cache tensors {k, v, seg
    [, k_scale, v_scale]}, chunk_seg (B, T)). ``lengths``, ``seg_count``
    and ``last_logits`` are not committed: the caller commits them after
    acceptance.
    """
    B, T = tokens.shape
    dev = tokens.device
    S = state["seg"].shape[1]
    lengths = state["lengths"]
    active = state["active"]
    offs = torch.arange(T, device=dev)
    wpos = (lengths[:, None] + offs[None, :]).clamp_max(S - 1)  # (B, T)
    bidx = torch.arange(B, device=dev)[:, None]
    if cfg.sep_id is not None:
        seg_inc = torch.cumsum((tokens == cfg.sep_id).to(torch.int32), dim=1,
                               dtype=torch.int32)
    else:
        seg_inc = torch.zeros((B, T), dtype=torch.int32, device=dev)
    chunk_seg = state["seg_count"][:, None] + seg_inc  # (B, T)

    x = F.embedding(tokens, model.tok_emb.weight).to(cfg.dtype)  # (B, T, C)
    pos_clip = (lengths[:, None] + offs[None, :]).clamp_max(cfg.block_size - 1)
    if cfg.use_rope:
        cos_full, sin_full = rope_cos_sin(
            cfg.block_size, cfg.head_dim, cfg.rope_base, cfg.dtype, dev)
        cos = cos_full[pos_clip][:, None]  # (B, 1, T, D)
        sin = sin_full[pos_clip][:, None]
    else:
        x = x + model.pos_emb.weight[pos_clip].to(cfg.dtype)

    seg = state["seg"]
    seg[bidx, wpos] = torch.where(active[:, None], chunk_seg, seg[bidx, wpos])
    mask_add = verify_mask(seg, lengths, chunk_seg, wpos)

    kv_quant = "k_scale" in state
    for layer, block in enumerate(model.blocks):
        h = _layer_norm(block.ln1, x)
        q, k, v = _qkv(block, h, cfg)  # (B, Hq, T, D), (B, Hkv, T, D)
        if cfg.use_rope:
            q = q * cos + rotate_half(q) * sin
            k = k * cos + rotate_half(k) * sin
        if kv_quant:
            k, k_sc = quantize_kv(k)  # int8 (B, Hkv, T, D), f32 (B, Hkv, T)
            v, v_sc = quantize_kv(v)
            # the routed (B, 1) and (B, T) indices around ':' go first:
            # the target block is (B, T, Hkv), as in JAX
            state["k_scale"][layer][bidx, :, wpos] = k_sc.transpose(1, 2)
            state["v_scale"][layer][bidx, :, wpos] = v_sc.transpose(1, 2)
        # T packed (B, T, P) rows per layer
        state["k"][layer][bidx, wpos] = k.transpose(1, 2).reshape(B, T, -1).to(
            state["k"].dtype)
        state["v"][layer][bidx, wpos] = v.transpose(1, 2).reshape(B, T, -1).to(
            state["v"].dtype)
        y = _attend_chunk(cfg, q, state, mask_add, layer)  # (B, Hq, T, D) f32
        y = y.to(cfg.dtype).transpose(1, 2).reshape(B, T, cfg.n_embd)  # this rank's heads
        x = block_epilogue(block, cfg, x, y)

    x = _layer_norm(model.ln_f, x)
    logits = _lm_logits(model, cfg, x).float()  # (B, T, V)
    upd = {key: state[key] for key in ("k", "v", "seg", "k_scale", "v_scale")
           if key in state}
    return logits, upd, chunk_seg


@torch.no_grad()
def _speculative_round(model: CodonGPT, cfg: CodonGPTConfig, state: dict,
                       sampling: dict, table: torch.Tensor,
                       generator: torch.Generator | None, n_draft: int,
                       allowed_mask: torch.Tensor | None, use_filters: bool = True):
    """One draft → verify → accept round; returns (state, tokens, counts).

    tokens: (B, K+1) = [t0, d1..dK]; counts: (B,) tokens emitted this round
    (1 + accepted, 0 for inactive slots): tokens[:, :counts] are committed,
    the rest were rejected drafts. Updates ``state`` in place.
    """
    K = int(n_draft)
    S = state["seg"].shape[1]
    active = state["active"]

    # the pending distribution: raw logits (a fresh admission) take the
    # slot's sampling transform; a previous round's residual or bonus row
    # is already transformed and is sampled as it is
    P0 = torch.where(
        state["logits_raw"][:, None],
        _slot_probs(state["last_logits"], sampling, allowed_mask, use_filters),
        torch.exp(state["last_logits"]),
    )
    t0 = sample_categorical(torch.log(P0), generator)

    prev, drafts, q_rows = t0, [], []
    for _ in range(K):
        rows = table[prev]  # (B, V)
        if use_filters:
            # the draft rows pass each slot's own sampling chain, as the
            # target rows do: the same transformed rows draft and enter the
            # acceptance test, so the scheme stays exact
            rows = _slot_probs(torch.log(rows), sampling, allowed_mask, True)
        prev = sample_categorical(torch.log(rows), generator)
        drafts.append(prev)
        q_rows.append(rows)
    drafts = torch.stack(drafts, dim=1)  # (B, K)
    Q = torch.stack(q_rows, dim=1)       # (B, K, V)

    tokens = torch.cat([t0[:, None], drafts], dim=1)  # (B, K+1)
    tokens = torch.where(active[:, None], tokens, torch.zeros_like(tokens))
    # tensor parallelism: every rank verifies rank 0's drafts and accepts on
    # rank 0's logits, so the caches stay equal
    tp = getattr(model, "tp", None)
    tpl.broadcast_(tokens, tp)

    logits_rows, _, chunk_seg = _ragged_verify(model, cfg, state, tokens)
    tpl.broadcast_(logits_rows, tp)
    P = _chunk_probs(logits_rows, sampling, allowed_mask, use_filters)  # (B, K+1, V)
    uniforms = torch.rand(drafts.shape, generator=generator, device=drafts.device)
    m, next_probs = speculative_acceptance(P, Q, drafts, uniforms)

    lengths = state["lengths"]
    state["lengths"] = torch.where(active, (lengths + 1 + m).clamp_max(S), lengths)
    last_seg = torch.gather(chunk_seg, 1, m[:, None])[:, 0]
    state["seg_count"] = torch.where(active, last_seg, state["seg_count"])
    state["last_logits"] = torch.where(active[:, None], torch.log(next_probs),
                                       state["last_logits"])
    state["logits_raw"] = state["logits_raw"] & ~active
    counts = torch.where(active, 1 + m, torch.zeros_like(m))
    return state, tokens, counts


@torch.no_grad()
def serve_steps_speculative(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    state: dict,
    n_rounds: int,
    sampling: dict,
    table: torch.Tensor,
    generator: torch.Generator | None = None,
    allowed_mask: torch.Tensor | None = None,
    n_draft: int = 4,
    use_filters: bool = True,
) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """``n_rounds`` speculative rounds: the speculative counterpart of
    ``serve_steps``, with the same per-slot sampling params and allowed mask,
    but each round emits 1..K+1 tokens per slot.

    Returns (state, tokens (B, n_rounds, K+1), counts (B, n_rounds)); per
    slot and round only the first ``counts`` tokens are real. Nothing here
    waits for the device. Active slots need K+1 positions of cache headroom.
    """
    tokens, counts = [], []
    for _ in range(int(n_rounds)):
        state, toks, cnt = _speculative_round(
            model, cfg, state, sampling, table, generator, n_draft, allowed_mask,
            use_filters)
        tokens.append(toks)
        counts.append(cnt)
    return state, torch.stack(tokens, dim=1), torch.stack(counts, dim=1)


def speculative_cache_size(horizon: int, n_draft: int) -> int:
    """Cache positions of ``generate_tokens_speculative``: the horizon plus
    2(K+1) positions of chunk headroom, rounded up to ``CACHE_BUCKET``."""
    return -(-(int(horizon) + 2 * (int(n_draft) + 1)) // CACHE_BUCKET) * CACHE_BUCKET


@torch.no_grad()
def generate_tokens_speculative(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    prompts,
    n_tokens: int,
    generator: torch.Generator | None,
    table,
    n_draft: int,
    temperature: float = 1.0,
    kv_quant: bool = False,
    allowed_mask=None,
    *,
    device: str | torch.device | None = None,
):
    """Offline speculative generation (cf. ``generate_tokens``).

    Prefill, then draft → verify → accept rounds until every row has
    ``n_tokens``; emitted tokens land in a per-row cursor-indexed buffer and
    finished rows deactivate. The cache is sized to the horizon plus
    2(K+1) positions of chunk headroom, rounded up to ``CACHE_BUCKET``.
    ``allowed_mask``: optional (V,) bool restriction, the speculative
    counterpart of ``generate_masked_tokens``; restrict the ``table`` to the
    same set (``restrict_table``) or drafts outside it are always rejected.

    Returns (tokens (B, n_tokens), active row-rounds, emitted tokens); the
    two counts give the acceptance statistics. The loop reads one flag
    from the device per round.
    """
    device = resolve_device(device)
    check_on_device(model, device)
    prompts = torch.as_tensor(prompts, dtype=torch.long).to(device)
    B, Plen = prompts.shape
    K = int(n_draft)
    n_tokens = int(n_tokens)
    if Plen + n_tokens > cfg.block_size:
        raise ValueError(
            f"prompt+n_tokens {Plen + n_tokens} exceeds block_size {cfg.block_size}")
    S = speculative_cache_size(Plen + n_tokens, K)
    logits0, cache, _ = prefill(model, cfg, prompts, S, kv_quant, want_aux=False,
                                device=device)
    state = {
        "k": cache["k"],
        "v": cache["v"],
        "seg": cache["seg"],
        "lengths": torch.full((B,), Plen, dtype=torch.long, device=device),
        "seg_count": cache["seg_count"],
        "last_logits": logits0.float(),
        "logits_raw": torch.ones((B,), dtype=torch.bool, device=device),
        "active": torch.ones((B,), dtype=torch.bool, device=device),
    }
    if kv_quant:
        state["k_scale"] = cache["k_scale"]
        state["v_scale"] = cache["v_scale"]
    sampling = {
        "temps": torch.full((B,), float(temperature), dtype=torch.float32, device=device),
        "top_k": torch.zeros((B,), dtype=torch.int32, device=device),
        "top_p": torch.zeros((B,), dtype=torch.float32, device=device),
    }
    table = torch.as_tensor(np.asarray(table, np.float32)).to(device)
    if allowed_mask is not None:
        allowed_mask = torch.as_tensor(allowed_mask, dtype=torch.bool).to(device)
    # n_tokens columns plus one scratch column where overshoot past a row's
    # budget parks its writes
    out_buf = torch.zeros((B, n_tokens + 1), dtype=torch.long, device=device)
    filled = torch.zeros((B,), dtype=torch.long, device=device)
    row_rounds = torch.zeros((), dtype=torch.long, device=device)
    emitted = torch.zeros((), dtype=torch.long, device=device)
    bidx = torch.arange(B, device=device)[:, None]
    offs = torch.arange(K + 1, device=device)[None, :]
    while True:
        state["active"] = filled < n_tokens
        if not bool(state["active"].any()):
            break
        state, tokens, counts = _speculative_round(
            model, cfg, state, sampling, table, generator, K, allowed_mask,
            use_filters=False)
        real = offs < counts[:, None]
        idx = torch.where(real, filled[:, None] + offs, n_tokens).clamp_max(n_tokens)
        out_buf[bidx, idx] = torch.where(real, tokens, out_buf[:, n_tokens:])
        filled += counts
        row_rounds += state["active"].sum()
        emitted += counts.sum()
    return out_buf[:, :n_tokens], int(row_rounds), int(emitted)


def speculative_generate(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    prompts,
    n_tokens: int,
    generator: torch.Generator | None,
    table,
    n_draft: int = 4,
    temperature: float = 1.0,
    kv_quant: bool = False,
    *,
    device: str | torch.device | None = None,
):
    """Offline batched speculative sampling: (B, P) prompts → (B, n_tokens).

    The output distribution of ``generate_tokens`` (greedy: its tokens).
    Returns (tokens np.int64, stats) with ``rounds`` (mean active rounds per
    row), ``accept_rate`` (mean accepted drafts / K) and
    ``tokens_per_round``.
    """
    toks, row_rounds, emitted = generate_tokens_speculative(
        model, cfg, prompts, n_tokens, generator, table, n_draft, temperature,
        kv_quant, device=device)
    B = toks.shape[0]
    stats = {
        "rounds": row_rounds / max(1, B),
        "accept_rate": (emitted - row_rounds) / max(1, row_rounds * int(n_draft)),
        "tokens_per_round": emitted / max(1, row_rounds),
    }
    return toks.cpu().numpy(), stats


__all__ = [
    "fit_bigram_table",
    "generate_tokens_speculative",
    "restrict_table",
    "speculative_cache_size",
    "serve_steps_speculative",
    "speculative_acceptance",
    "speculative_generate",
]
