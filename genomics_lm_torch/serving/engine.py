"""Continuous-batching serving engine over the ragged KV cache.

Twin of ``genomics_lm_tpu/serving/engine.py``. The cached step of
``generation.decode`` advances every sequence at one shared length; here
every batch slot advances at its own position, writes its K/V row at its
own length, and masks attention with its own (length, segment) row. A
finished slot is retired on the host and re-admitted with a new request
without touching the other slots — the card always steps the full batch.

Engine flow (host side, ``ServingEngine``):

    submit(...) → pending queue
    step():  admit pending into free slots (right-padded bucket prefill)
             → ``serve_steps``: K ragged decode steps for the whole batch,
               sampling on the device
             → retire slots that hit a stop id / their token budget

Sampling is per slot: each request carries its own temperature (≤ 0 =
greedy), top-k and top-p; an optional vocabulary mask restricts sampling.
Draws come from one ``torch.Generator`` the engine owns, so they differ
from JAX's; greedy output is exact: a greedy request's tokens equal
``generation.decode.generate_tokens`` on its prompt alone.

Where JAX donates the serving state to XLA (``admit_many``,
``deactivate``, ``serve_steps``), the port updates the state tensors in
place. The decode attention of every layer goes through the CUDA kernel
(``ops/decode_attention.py``) when ``cfg.attention_impl == "flash"``; the
kernel consumes the per-slot additive mask and is oblivious to raggedness.

With ``speculative_k = K > 0`` and a bigram ``draft_table`` each sync chunk
is ``steps_per_sync`` draft → verify → accept rounds
(``serving/speculative.py``), each emitting 1..K+1 tokens per slot; the
verify chunk's attention is the CUDA chunk kernel under ``flash``.

Tensor-parallel serving (``mesh`` with a ``model`` axis of T > 1, one
process per rank, every rank running the same engine calls): each rank
holds its heads of every block (``parallel/tensor_parallel.py::
shard_model``) and its heads' lanes of the packed cache and of the int8
scales (JAX's ``serving_state_sharding``: the state is built at the local
config, ``tp_local_config``), so the decode kernel (the chunk
kernel in a speculative verify) runs per rank on its local heads with no
collective before the row-parallel projection, where the partial sums meet
in an all-reduce. Rank 0 of the model axis samples and broadcasts each
step's tokens (and a speculative round's drafts and verify logits), so the
ranks' caches never part. ``kv_heads`` and ``n_head`` must divide by T.
A MoE model's experts split by the expert rule (``parallel/sharding.py::
ep_spec``): a rank holds E/T whole experts and runs the routed tokens' MLP
for those only, the partial sums meeting in the same all-reduce. JAX's
engine splits every expert's hidden width instead (``tp_param_sharding``,
``genomics_lm_tpu/serving/engine.py:541-554``); both give the same
tokens, only the layout differs. An expert count that T does not divide
runs its experts whole on every rank.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from genomics_lm_torch.generation.decode import (
    CACHE_BUCKET,
    _decode_layers,
    _decode_mask,
    prefill,
    sample_categorical,
)
from genomics_lm_torch.models.codon_gpt import CodonGPT, _lm_logits
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.attention import NEG_INF
from genomics_lm_torch.parallel import tensor_parallel as tpl
from genomics_lm_torch.parallel.mesh import MODEL_AXIS
from genomics_lm_torch.utils.device import check_on_device, resolve_device

PROMPT_BUCKET = 16  # admission prompts right-pad to multiples of this


def _to_device(array, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host array → device tensor without waiting on the device's queue.

    A copy from pageable memory would synchronize the stream, so a CUDA
    copy goes through pinned memory and is enqueued behind the work
    already in flight.
    """
    t = torch.as_tensor(np.asarray(array)).to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _draft_table(draft_table, vocab_size: int, allowed_ids) -> np.ndarray:
    """The engine's (V, V) draft table: checked, then restricted to
    ``allowed_ids`` or floored so every row can be sampled."""
    if draft_table is None:
        raise ValueError("speculative_k > 0 requires a draft_table "
                         "(serving.speculative.fit_bigram_table)")
    table = np.asarray(draft_table, np.float32)
    if table.shape != (vocab_size, vocab_size):
        raise ValueError(f"draft_table shape {table.shape} != ({vocab_size}, {vocab_size})")
    if allowed_ids is not None:
        from genomics_lm_torch.serving.speculative import restrict_table

        allowed = np.zeros((vocab_size,), bool)
        allowed[np.asarray(allowed_ids, int)] = True
        return restrict_table(table, allowed)
    # strictly positive rows: a zero row would make the draft degenerate
    table = np.maximum(table, 1e-8)
    return table / table.sum(axis=1, keepdims=True)


def init_serving_state(
    cfg: CodonGPTConfig,
    slots: int,
    cache_size: int | None = None,
    kv_quant: bool = False,
    *,
    device: str | torch.device | None = None,
) -> dict:
    """Empty ragged serving state for ``slots`` concurrent sequences."""
    device = resolve_device(device)
    S = cfg.block_size if cache_size is None else int(cache_size)
    shape = (cfg.n_layer, slots, S, cfg.kv_heads * cfg.head_dim)
    kv_dtype = torch.int8 if kv_quant else cfg.dtype
    state = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "seg": torch.zeros((slots, S), dtype=torch.int32, device=device),
        "lengths": torch.zeros((slots,), dtype=torch.long, device=device),
        "seg_count": torch.zeros((slots,), dtype=torch.int32, device=device),
        "last_logits": torch.full((slots, cfg.vocab_size), NEG_INF,
                                  dtype=torch.float32, device=device),
        # True: last_logits are raw model logits (transformed at sampling);
        # False: a speculative round stored an already-transformed residual
        # or bonus distribution as log-probabilities (serving/speculative.py)
        "logits_raw": torch.ones((slots,), dtype=torch.bool, device=device),
        "active": torch.zeros((slots,), dtype=torch.bool, device=device),
    }
    if kv_quant:
        scale_shape = (cfg.n_layer, slots, cfg.kv_heads, S)
        state["k_scale"] = torch.zeros(scale_shape, dtype=torch.float32, device=device)
        state["v_scale"] = torch.zeros(scale_shape, dtype=torch.float32, device=device)
    return state


@torch.no_grad()
def admit_many(model: CodonGPT, cfg: CodonGPTConfig, state: dict, slot_idx,
               prompts, prompt_lens, valid) -> dict:
    """Prefill a batch of right-padded prompts and install them into slots.

    ``prompts``: (N, P) ids, row i real in [0, prompt_lens[i]); rows with
    ``valid[i]`` False are ignored. ``slot_idx``: (N,) target slots,
    distinct among valid lanes. The index arrays are host arrays.

    Valid lanes overwrite positions [0, P) of their slot's cache, scales
    and segment ids; positions ≥ P keep their old values (they sit above
    the slot's length, so the ragged mask never attends them and decode
    writes overwrite them one by one). Length, segment count and last
    logits route exactly. Only the valid lanes are prefilled — JAX
    prefills all N at a fixed shape to compile once; eager PyTorch has
    nothing to compile. Updates ``state`` in place and returns it.
    """
    device = state["k"].device
    valid = np.asarray(valid, dtype=bool)
    lanes = np.flatnonzero(valid)
    if lanes.size == 0:
        return state
    prompts = np.asarray(prompts)
    P = prompts.shape[1]
    lens = np.asarray(prompt_lens)[lanes]
    slots = _to_device(np.asarray(slot_idx)[lanes], device, torch.long)
    logits, mini, _ = prefill(
        model, cfg, _to_device(prompts[lanes], device, torch.long), P,
        "k_scale" in state, _to_device(np.maximum(lens - 1, 0), device, torch.long),
        want_aux=False, device=device)
    # packed caches (L, B, S, P): slot axis 1, positions axis 2
    state["k"][:, slots, :P] = mini["k"]
    state["v"][:, slots, :P] = mini["v"]
    if "k_scale" in state:
        # scales (L, B, Hkv, S): slot axis 1, positions axis 3
        state["k_scale"][:, slots, :, :P] = mini["k_scale"]
        state["v_scale"][:, slots, :, :P] = mini["v_scale"]
    state["seg"][slots, :P] = mini["seg"]
    state["lengths"][slots] = _to_device(lens, device, torch.long)
    state["seg_count"][slots] = mini["seg_count"]
    state["last_logits"][slots] = logits.float()
    state["logits_raw"][slots] = True
    state["active"][slots] = True
    return state


def deactivate(state: dict, slot_mask) -> dict:
    """Clear ``active`` for every slot where the host mask ``slot_mask`` is True."""
    freed = _to_device(slot_mask, state["active"].device, torch.bool)
    state["active"] &= ~freed
    return state


@torch.no_grad()
def _ragged_decode(model: CodonGPT, cfg: CodonGPTConfig, state: dict,
                   token: torch.Tensor):
    """One decode step with per-slot positions; returns (logits, state).

    The layer stack is ``generation.decode._decode_layers``, as for
    ``decode_step``; only the position bookkeeping differs: the scalar
    length becomes the (B,) ``lengths``, and each slot writes its K/V row
    at its own position ``min(length, S-1)``. Inactive slots keep their
    length: they rewrite their own frozen slot, which is never attended.
    Updates ``state`` in place.
    """
    B = token.shape[0]
    S = state["seg"].shape[1]
    lengths = state["lengths"]
    active = state["active"]
    wpos = lengths.clamp_max(S - 1)
    bidx = torch.arange(B, device=token.device)
    new_seg = state["seg_count"]
    if cfg.sep_id is not None:
        new_seg = new_seg + (token == cfg.sep_id).to(torch.int32)

    mask_add = _decode_mask(state["seg"], new_seg, lengths[:, None],
                            wpos[:, None], cfg.sep_id)
    x = _decode_layers(model, cfg, state, token,
                       lengths.clamp_max(cfg.block_size - 1), wpos, mask_add)
    logits = _lm_logits(model, cfg, x)[:, 0].float()

    state["seg"][bidx, wpos] = torch.where(active, new_seg, state["seg"][bidx, wpos])
    state["lengths"] = torch.where(active, (lengths + 1).clamp_max(S), lengths)
    state["seg_count"] = torch.where(active, new_seg, state["seg_count"])
    state["last_logits"] = torch.where(active[:, None], logits, state["last_logits"])
    return logits, state


def filtered_sampling_logits(logits: torch.Tensor, sampling: dict,
                             allowed_mask: torch.Tensor | None,
                             use_filters: bool = True):
    """Allowed-mask → temperature → top-k → top-p sampling filter chain.

    Returns (greedy token (B,), filtered temperature-scaled logits (B, V)).
    ``use_filters`` False skips the top-k/top-p sort chain, for callers
    that know every slot has both disabled (the chain is then the identity).
    """
    temps = sampling["temps"]
    top_k = sampling["top_k"]
    top_p = sampling["top_p"]
    V = logits.shape[-1]
    if allowed_mask is not None:
        logits = logits.masked_fill(~allowed_mask[None, :], NEG_INF)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    if not use_filters:
        return greedy, scaled
    # top-k: drop everything below the k-th largest (k = 0 disables)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    scaled = scaled.masked_fill((top_k > 0)[:, None] & (scaled < kth), NEG_INF)
    # top-p (nucleus): keep the shortest descending-probability prefix whose
    # cumulative mass reaches p (the argmax always survives)
    desc_k = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc_k, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    nucleus_on = (top_p > 0) & (top_p < 1.0)
    p_eff = torch.where(nucleus_on, top_p, torch.ones_like(top_p))
    n_keep = ((csum - probs) < p_eff[:, None]).sum(dim=-1).clamp_min(1)
    thr = torch.gather(desc_k, -1, (n_keep - 1)[:, None])
    scaled = scaled.masked_fill(nucleus_on[:, None] & (scaled < thr), NEG_INF)
    return greedy, scaled


@torch.no_grad()
def serve_steps(
    model: CodonGPT,
    cfg: CodonGPTConfig,
    state: dict,
    n_steps: int,
    sampling: dict,
    generator: torch.Generator | None = None,
    allowed_mask: torch.Tensor | None = None,
    use_filters: bool = True,
) -> tuple[dict, torch.Tensor]:
    """``n_steps`` ragged decode steps with sampling on the device.

    ``sampling``: per-slot tensors — ``temps`` (B,) f32 (≤ 0 = greedy),
    ``top_k`` (B,) int (0 = off), ``top_p`` (B,) f32 (≤ 0 or ≥ 1 = off).
    ``allowed_mask``: optional (V,) bool vocabulary restriction. Returns
    (state, (B, n_steps) sampled tokens); tokens of inactive slots are 0.
    Nothing here waits for the device: the host syncs only when it reads
    a chunk's tokens.
    """
    temps = sampling["temps"]
    tokens = []
    for _ in range(int(n_steps)):
        greedy, scaled = filtered_sampling_logits(
            state["last_logits"], sampling, allowed_mask, use_filters)
        sampled = sample_categorical(scaled, generator)
        token = torch.where(temps <= 0, greedy, sampled)
        token = torch.where(state["active"], token, torch.zeros_like(token))
        # tensor parallelism: every rank decodes rank 0's tokens
        tpl.broadcast_(token, getattr(model, "tp", None))
        _, state = _ragged_decode(model, cfg, state, token)
        tokens.append(token)
    return state, torch.stack(tokens, dim=1)


@dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    stop_ids: tuple[int, ...] = ()
    top_k: int = 0       # 0 = disabled
    top_p: float = 0.0   # <=0 or >=1 = disabled


@dataclass
class RequestResult:
    request_id: int
    prompt: list[int]
    tokens: list[int] = field(default_factory=list)
    finish_reason: str = ""  # "stop" | "length" | "cancelled"


class ServingEngine:
    """Host-side continuous-batching scheduler over ``serve_steps``.

    One engine owns one device state (``slots`` concurrent sequences, one
    static cache). ``submit`` enqueues; ``step`` admits + decodes one
    chunk + retires; ``run`` drains the queue. Greedy requests produce
    output independent of co-scheduling. Runs on ``device`` (default
    ``cuda``; raises without CUDA unless a device is named); ``model``
    must already live there.
    """

    def __init__(
        self,
        model: CodonGPT,
        cfg: CodonGPTConfig,
        *,
        slots: int = 8,
        max_seq_len: int | None = None,
        kv_quant: bool = False,
        steps_per_sync: int = 16,
        allowed_ids: list[int] | None = None,
        seed: int = 0,
        mesh=None,
        speculative_k: int = 0,
        draft_table=None,
        pipeline_depth: int = 1,
        warm_spec_filters: bool = False,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        check_on_device(model, self.device)
        tp = mesh.axis_size(MODEL_AXIS) if mesh is not None else 1
        # the mesh is kept only when it splits the model
        self.mesh = mesh if tp > 1 else None
        if tp > 1:
            # each rank's heads of a copy (the caller's model stays whole)
            model = tpl.shard_model(model, tpl.TPContext.from_mesh(mesh), copy_model=True)
        self.model = model
        self.cfg = cfg
        # the decode paths' config: this rank's heads, their cache lanes
        self._ccfg = tpl.tp_local_config(cfg, tp)
        self.slots = int(slots)
        self.S = int(max_seq_len or cfg.block_size)
        if self.S > cfg.block_size:
            raise ValueError("max_seq_len exceeds model block_size")
        self.kv_quant = bool(kv_quant)
        self.steps_per_sync = int(steps_per_sync)
        # chunks kept in flight by the pipelined drain (see run())
        self.pipeline_depth = max(1, int(pipeline_depth))
        # speculative decoding: each sync chunk is steps_per_sync rounds, and
        # the cache takes K+1 positions of headroom for the optimistic chunk
        # writes, rounded up to the cache bucket
        self._spec_k = int(speculative_k)
        cache_cap = self.S
        if self._spec_k:
            self._table = _to_device(
                _draft_table(draft_table, cfg.vocab_size, allowed_ids),
                self.device, torch.float32)
            cache_cap = -(-(self.S + self._spec_k + 1) // CACHE_BUCKET) * CACHE_BUCKET
        self.state = init_serving_state(self._ccfg, self.slots, cache_cap, kv_quant,
                                        device=self.device)
        # small admission bucket: prompts at or under this length prefill
        # at this width, longer ones at the full window
        self._admit_small = min(
            ((64 + PROMPT_BUCKET - 1) // PROMPT_BUCKET) * PROMPT_BUCKET, self.S)
        self._temps = np.zeros((self.slots,), np.float32)
        self._topk = np.zeros((self.slots,), np.int32)
        self._topp = np.zeros((self.slots,), np.float32)
        self._samp_dev = self._sampling_device()  # refreshed on admission
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(seed))
        self._allowed = None
        if allowed_ids is not None:
            m = np.zeros((cfg.vocab_size,), bool)
            m[np.asarray(allowed_ids, int)] = True
            self._allowed = _to_device(m, self.device, torch.bool)
        self._spec_rounds = 0   # active (slot, round) pairs retired
        self._spec_emitted = 0  # tokens those rounds emitted
        # the top-k/top-p chain turns on at the first filtered request and
        # stays on (warm_spec_filters: on from the start)
        self._spec_filters_seen = bool(warm_spec_filters and self._spec_k)
        self.pending: list[Request] = []
        self.results: dict[int, RequestResult] = {}
        self._completed = 0  # finished (incl. cancelled); thread-safe to read
        self._decode_steps = 0  # ragged decode steps dispatched
        self._verify_rounds = 0  # speculative rounds dispatched
        self._slot_req: list[Request | None] = [None] * self.slots
        self._next_id = 0

    def _sampling_device(self) -> dict:
        return {
            "temps": _to_device(self._temps, self.device, torch.float32),
            "top_k": _to_device(self._topk, self.device, torch.int32),
            "top_p": _to_device(self._topp, self.device, torch.float32),
        }

    # -- queue -------------------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int,
               temperature: float = 0.0,
               stop_ids: tuple[int, ...] = (),
               top_k: int = 0, top_p: float = 0.0) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        tokens = list(map(int, prompt))
        bad = [t for t in tokens if not 0 <= t < self.cfg.vocab_size]
        if bad:
            raise ValueError(
                f"prompt token {bad[0]} outside vocabulary [0, {self.cfg.vocab_size})")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        budget = len(prompt) + int(max_new_tokens)
        if budget > self.S:
            raise ValueError(
                f"prompt+max_new_tokens {budget} exceeds engine max_seq_len {self.S}")
        rid = self._next_id
        self._next_id += 1
        self.pending.append(Request(rid, tokens,
                                    int(max_new_tokens), float(temperature),
                                    tuple(stop_ids), int(top_k), float(top_p)))
        return rid

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def cancel(self, request_id: int) -> bool:
        """Cancel a request. Pending requests are dropped; an in-flight
        request's slot is freed at once (its decoded tokens so far stay in
        ``results`` with finish_reason "cancelled"). Returns False if the
        request is unknown or already finished."""
        for i, req in enumerate(self.pending):
            if req.request_id == request_id:
                del self.pending[i]
                res = self.results.setdefault(
                    request_id, RequestResult(request_id, list(req.prompt)))
                res.finish_reason = "cancelled"
                self._completed += 1
                return True
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.request_id == request_id:
                self.results[req.request_id].finish_reason = "cancelled"
                self._completed += 1
                self._slot_req[slot] = None
                freed = np.zeros((self.slots,), bool)
                freed[slot] = True
                deactivate(self.state, freed)
                return True
        return False

    def stats(self) -> dict:
        """Scheduler observability snapshot (host-side, no device sync)."""
        out = {
            "slots": self.slots,
            "active": self.n_active,
            "pending": len(self.pending),
            "completed": self._completed,
            "max_seq_len": self.S,
            "kv_quant": self.kv_quant,
            "steps_per_sync": self.steps_per_sync,
            "tensor_parallel": self.mesh is not None,
            "speculative_k": self._spec_k,
            "decode_steps": self._decode_steps,
            "verify_rounds": self._verify_rounds,
        }
        if self._spec_k and self._spec_rounds:
            # clamped: a read from another thread between the two counter
            # updates can see a transiently high emitted total
            rate = ((self._spec_emitted - self._spec_rounds)
                    / (self._spec_rounds * self._spec_k))
            out["speculative_accept_rate"] = round(min(max(rate, 0.0), 1.0), 4)
            out["speculative_tokens_per_round"] = round(
                min(self._spec_emitted / self._spec_rounds, self._spec_k + 1), 3)
        return out

    # -- scheduling --------------------------------------------------------
    def _admit_pending(self) -> None:
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        take = self.pending[: len(free)]
        if not take:
            return
        self.pending = self.pending[len(take):]
        longest = max(len(r.prompt) for r in take)
        # the same two admission widths as JAX (one small bucket, the full
        # window), so a prompt pads identically on both
        bucket = self._admit_small if longest <= self._admit_small else self.S
        N = self.slots
        prompts = np.zeros((N, bucket), np.int64)
        lens = np.ones((N,), np.int64)
        slot_idx = np.zeros((N,), np.int64)
        valid = np.zeros((N,), bool)
        for i, (req, slot) in enumerate(zip(take, free)):
            P = len(req.prompt)
            prompts[i, :P] = req.prompt
            lens[i] = P
            slot_idx[i] = slot
            valid[i] = True
            self._slot_req[slot] = req
            self._temps[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self.results[req.request_id] = RequestResult(
                req.request_id, list(req.prompt))
        self._samp_dev = self._sampling_device()
        admit_many(self.model, self._ccfg, self.state, slot_idx, prompts, lens, valid)

    def _retire(self, tokens: np.ndarray,
                snapshot: list[Request | None] | None = None,
                ) -> list[tuple[int, list[int], str]]:
        """Consume one chunk of sampled tokens; free finished slots.

        ``snapshot`` is the slot→request mapping at the chunk's dispatch
        time: tokens for a slot that has since been re-admitted to another
        request are dropped instead of being credited to the new request.

        Returns streaming events: one (request_id, new_tokens,
        finish_reason) per request that produced tokens this chunk, with
        finish_reason "" while the request is still running."""
        finished = np.zeros((self.slots,), bool)
        events: list[tuple[int, list[int], str]] = []
        for slot, req in enumerate(snapshot or self._slot_req):
            if req is None or self._slot_req[slot] is not req:
                continue
            res = self.results[req.request_id]
            fresh: list[int] = []
            for t in tokens[slot]:
                t = int(t)
                res.tokens.append(t)
                fresh.append(t)
                if t in req.stop_ids:
                    res.finish_reason = "stop"
                    break
                if len(res.tokens) >= req.max_new_tokens:
                    res.finish_reason = "length"
                    break
            if fresh:
                events.append((req.request_id, fresh, res.finish_reason))
            if res.finish_reason:
                finished[slot] = True
                self._slot_req[slot] = None
                self._completed += 1
        if finished.any():
            deactivate(self.state, finished)
        return events

    def _dispatch_chunk(self):
        """Admit pending, then enqueue one decode chunk and its token copy.

        Returns ((host tokens, ready event), slot→request snapshot), or
        None when nothing is active. The copy to the host is non-blocking:
        the tokens are read only after ``ready`` has fired. Overshoot past
        per-request budgets within the chunk is discarded at retirement."""
        self._admit_pending()
        if self.n_active == 0:
            return None
        # the top-k/top-p chain runs only while a live request uses it (slot
        # params persist after retirement, hence the mask to live slots)
        live = np.array([r is not None for r in self._slot_req])
        use_filters = bool((self._topk[live] > 0).any()
                           or ((self._topp[live] > 0) & (self._topp[live] < 1)).any())
        if self._spec_k:
            from genomics_lm_torch.serving.speculative import serve_steps_speculative

            use_filters = self._spec_filters_seen = self._spec_filters_seen or use_filters
            self.state, toks, counts = serve_steps_speculative(
                self.model, self._ccfg, self.state, self.steps_per_sync,
                self._samp_dev, self._table, self._generator, self._allowed,
                self._spec_k, use_filters)
            self._verify_rounds += self.steps_per_sync
            # counts and tokens in one (slots, rounds, 1 + K+1) tensor: one
            # copy to the host per chunk
            toks = torch.cat([counts[:, :, None], toks], dim=2)
        else:
            self.state, toks = serve_steps(
                self.model, self._ccfg, self.state, self.steps_per_sync,
                self._samp_dev, self._generator, self._allowed, use_filters)
            self._decode_steps += self.steps_per_sync
        if toks.device.type != "cuda":
            return (toks, None), list(self._slot_req)
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return (host, ready), list(self._slot_req)

    def _chunk_token_rows(self, payload):
        """Wait for a dispatched chunk's tokens; return one token row per slot.

        A plain chunk is a dense (slots, steps) array. A speculative chunk
        is packed (slots, rounds, 1 + K+1): per round, column 0 is the
        emitted count and only that many of the other columns are real.
        """
        host, ready = payload
        if ready is not None:
            ready.synchronize()
        rows = host.numpy()
        if not self._spec_k:
            return rows
        counts, toks = rows[:, :, 0], rows[:, :, 1:]
        # counts > 0 marks an active (slot, round) pair, which emitted
        # 1 + accepted tokens; emitted first, so that a concurrent stats()
        # never sees fewer tokens than rounds
        self._spec_emitted += int(counts.sum())
        self._spec_rounds += int((counts > 0).sum())
        return [[int(t) for r in range(toks.shape[1]) for t in toks[s, r, : counts[s, r]]]
                for s in range(self.slots)]

    def step(self) -> int:
        """Admit + decode one chunk + retire. Returns #tokens sampled (in
        speculative mode, the tokens the chunk's rounds emitted)."""
        chunk = self._dispatch_chunk()
        if chunk is None:
            return 0
        rows = self._chunk_token_rows(chunk[0])
        self._retire(rows, chunk[1])
        if self._spec_k:
            return sum(len(r) for r in rows)
        return int(self.n_active and self.steps_per_sync * self.slots)

    def run(self, max_chunks: int = 10_000, *,
            pipelined: bool = True,
            pipeline_depth: int | None = None) -> dict[int, RequestResult]:
        """Drain the queue; returns {request_id: RequestResult}.

        ``pipelined`` keeps decode chunks in flight: chunk N+1 is enqueued
        on the device before chunk N's tokens are read back, so the host's
        bookkeeping overlaps device work. GREEDY outputs are identical at
        every depth; sampled outputs come from the same per-token
        distribution, but the realized draws can differ (pipelining delays
        re-admission into a freed slot)."""
        for _ in self.stream(max_chunks, pipelined=pipelined,
                             pipeline_depth=pipeline_depth):
            pass
        return self.results

    def stream(self, max_chunks: int = 10_000, *, pipelined: bool = True,
               pipeline_depth: int | None = None):
        """Drain the queue, yielding (request_id, new_tokens, finish_reason)
        events as they are decoded — one per request per chunk in which it
        produced tokens; ``finish_reason`` is "" until the final event.
        ``self.results`` accumulates the full outputs as usual."""
        if not pipelined:
            for _ in range(max_chunks):
                if not self.pending and self.n_active == 0:
                    return
                chunk = self._dispatch_chunk()
                if chunk is not None:
                    yield from self._retire(self._chunk_token_rows(chunk[0]), chunk[1])
            raise RuntimeError("serving run did not drain within max_chunks")

        depth = max(1, int(pipeline_depth or self.pipeline_depth))
        inflight: deque = deque()  # (tokens, slot→request snapshot) FIFO
        try:
            for _ in range(max_chunks):
                if not self.pending and self.n_active == 0 and not inflight:
                    return
                # keep ``depth`` chunks in flight WHILE the oldest is read
                # back and retired below (fill to depth + 1 before popping)
                while len(inflight) < depth + 1:
                    chunk = self._dispatch_chunk()
                    if chunk is None:
                        break
                    inflight.append(chunk)
                if not inflight:
                    return
                # pop BEFORE yielding: if the consumer closes the generator
                # mid-yield, ``inflight`` holds exactly the chunks still
                # needing retirement (no double retire)
                prev = inflight.popleft()
                yield from self._retire(self._chunk_token_rows(prev[0]), prev[1])
        finally:
            # an abandoned generator must not drop dispatched-but-unretired
            # chunks: the device state already advanced
            while inflight:
                prev = inflight.popleft()
                self._retire(self._chunk_token_rows(prev[0]), prev[1])
        raise RuntimeError("serving run did not drain within max_chunks")


__all__ = [
    "PROMPT_BUCKET",
    "Request",
    "RequestResult",
    "ServingEngine",
    "admit_many",
    "deactivate",
    "filtered_sampling_logits",
    "init_serving_state",
    "serve_steps",
]
