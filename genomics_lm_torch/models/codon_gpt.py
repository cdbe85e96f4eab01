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
auxiliary heads, shape guidance, LoRA adapters, and training: the
cross-entropy loss, dropout and remat. Embedding and MLP-output dropout are
plain draws from the caller's ``torch.Generator``; attention dropout runs
inside the attention op (the flash kernels on the card) from a seed drawn
from the same generator. Attention follows ``cfg.attention_impl``.

LoRA (``training/lora.py``): a ``LoRA`` module on a block linear adds
``scale * (x @ lora_a) @ lora_b`` to its output, as the JAX ``_linear``
does when its parameter dict holds ``lora_a``; a fused QKV linear keeps
three adapters (``attn.qkv_lora``) beside the concatenated base product,
as JAX's fused branch does. ``lora_scale`` never trains
(``requires_grad=False``). Cached decode and serving reuse ``_linear`` and
``_qkv``, so an adapted model decodes unmerged.

Remat (``cfg.use_checkpoint``, JAX's ``jax.checkpoint`` around the block):
each block runs under ``torch.utils.checkpoint``, and the recomputed block
draws the same dropout masks and attention seed as the first pass: it
runs on a copy of the caller's generator taken at the block's start (JAX
replays the block's key).

Weight-only int8 (``ops/quant.py::quantize_params``): a block linear
becomes an ``Int8Linear`` (int8 ``w_q``, float32 ``scale`` per output
channel, float32 bias); ``_linear`` computes ``(x @ w_q.T) * scale + b``
in x's dtype, JAX's order (``codon_gpt.py:148-155``), and a fused QKV
``Int8Linear`` is JAX's concatenation of the three quantized projections
(``:212-225``). Every path that goes through ``_linear``/``_qkv`` — the
forward, prefill, the decode step, the engine's ragged decode and the
speculative verify — serves an int8 model unchanged.

Mixture of experts (``cfg.moe_experts``, JAX ``_moe_mlp``,
``codon_gpt.py:285-353``): a block's MLP is a ``MoEMLP``, its expert
weights stacked on a leading E axis in JAX's layout, beside a bias-free
``router``. ``_moe_mlp`` routes each token to its top-k experts by a
float32 router, grants expert slots in (rank, token) priority up to the
capacity in training and drops the rest to the residual, and runs the
expert products as batched matmuls over E; dispatch and combine are index
operations into and out of an (E, C, D) buffer, the function of JAX's
one-hot einsums. ``block_epilogue`` routes every path: capped in training,
dropless everywhere else (evaluation, prefill, decode, serving, the
speculative verify, ``hidden_states``), so each token's output is
independent of the others'. ``forward(..., return_aux=True)`` returns the
router's load-balancing loss, the mean over layers, as ``moe_aux_loss``.

Tensor parallelism (``parallel/tensor_parallel.py::shard_model``): a block
of a rank holds its heads of the attention and its slice of the MLP, and
``block.tp`` / ``model.tp`` carry the model axis. ``_qkv`` enters through a
column-parallel entry, the projection and the MLP's down linear leave
through row-parallel exits (the bias after the sum), and the forward runs
each rank's attention on its local heads with the config of one rank's
heads (``tp_local_config``); with ``residual_sharding`` the stream between
them is split over T (sequence parallelism), its dropout masks drawn for
the whole sequence and sliced. The serving and decode paths take the same
pieces, so a tensor-parallel model decodes unchanged.

``hidden_states``, ``forward_hidden`` and ``attention_maps`` are JAX's
extraction forwards (``codon_gpt.py:574-662``): the canonical states after
the embedding, every block and the final norm, and each layer's attention
probabilities under the causal, window and ``<SEP>`` mask.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops.attention import attention, sdpa
from genomics_lm_torch.ops.losses import cross_entropy
from genomics_lm_torch.ops.masks import segment_ids_from_tokens, structure_mask
from genomics_lm_torch.ops.quant import quantize_weight
from genomics_lm_torch.parallel import tensor_parallel as tpl


class LoRA(nn.Module):
    """A rank-r adapter of one linear, in the JAX leaves' orientation:
    ``lora_a`` (fan_in, r), ``lora_b`` (r, fan_out) and the frozen output
    scale ``lora_scale`` (alpha / r). Zeros until ``training/lora.py`` or a
    loaded tree fills them."""

    def __init__(self, fan_in: int, fan_out: int, rank: int):
        super().__init__()
        self.lora_a = nn.Parameter(torch.zeros(fan_in, rank))
        self.lora_b = nn.Parameter(torch.zeros(rank, fan_out))
        self.lora_scale = nn.Parameter(torch.ones(()), requires_grad=False)

    def delta(self, x: torch.Tensor, tp_index=None) -> torch.Tensor:
        """The adapter's output; under tensor parallelism (``tp_index``, or
        the adapter's own for a fused QKV's) through this rank's heads'
        slice of ``lora_b`` (a column linear) or ``lora_a`` (a row one)."""
        a, b = self.lora_a, self.lora_b
        tp_index = tp_index or getattr(self, "tp_index", None)
        if tp_index is not None:
            kind, idx = tp_index
            if kind == "col":
                b = tpl.take(b, 1, idx)
            else:
                a = tpl.take(a, 0, idx)
        d = torch.matmul(torch.matmul(x, a.to(x.dtype)), b.to(x.dtype))
        return self.lora_scale.to(x.dtype) * d


class Int8Linear(nn.Module):
    """A weight-only int8 linear: ``w_q`` (fan_out, fan_in) int8 and its
    float32 per-output-channel ``scale`` (fan_out,), beside the float32
    ``bias`` (or None), all frozen: an int8 model serves, it does not
    train."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.w_q = nn.Parameter(torch.zeros(out_features, in_features, dtype=torch.int8),
                                requires_grad=False)
        self.scale = nn.Parameter(torch.ones(out_features), requires_grad=False)
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features), requires_grad=False)
        else:
            self.register_parameter("bias", None)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        """``lin`` quantized (``ops/quant.py::quantize_weight``), on its device."""
        q = cls(lin.in_features, lin.out_features, lin.bias is not None).to(lin.weight.device)
        with torch.no_grad():
            w_q, scale = quantize_weight(lin.weight)
            q.w_q.copy_(w_q)
            q.scale.copy_(scale)
            if lin.bias is not None:
                q.bias.copy_(lin.bias)
        return q


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


def _uniform(shape: tuple[int, ...], fan_in: int) -> nn.Parameter:
    """U(±1/√fan_in), the JAX ``_linear_init`` distribution."""
    k = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.empty(shape).uniform_(-k, k))


class ExpertLinear(nn.Module):
    """One linear per expert in JAX's layout: ``w`` (E, fan_in, fan_out) and
    ``b`` (E, fan_out) or none."""

    def __init__(self, n_experts: int, fan_in: int, fan_out: int, bias: bool = True):
        super().__init__()
        self.w = _uniform((n_experts, fan_in, fan_out), fan_in)
        if bias:
            self.b = _uniform((n_experts, fan_out), fan_in)
        else:
            self.register_parameter("b", None)


class MoEMLP(nn.Module):
    """The expert bank of a MoE block: ``fc``/``proj`` (GELU) or ``w_gate``/
    ``w_up``/``w_down`` (SwiGLU, bias-free), each an ``ExpertLinear``."""

    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        E, D, H = cfg.moe_experts, cfg.n_embd, cfg.mlp_hidden
        if cfg.use_swiglu:
            self.w_gate = ExpertLinear(E, D, H, bias=False)
            self.w_up = ExpertLinear(E, D, H, bias=False)
            self.w_down = ExpertLinear(E, H, D, bias=False)
        else:
            self.fc = ExpertLinear(E, D, H)
            self.proj = ExpertLinear(E, H, D)


class Router(nn.Module):
    """The bias-free router ``w`` (D, E) of a MoE block."""

    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        self.w = _uniform((cfg.n_embd, cfg.moe_experts), cfg.n_embd)


class Block(nn.Module):
    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
        D = cfg.n_embd
        self.ln1 = nn.LayerNorm(D)
        self.attn = _Attention(cfg)
        self.ln2 = nn.LayerNorm(D)
        if cfg.moe_experts:
            self.mlp = MoEMLP(cfg)
            self.router = Router(cfg)
        else:
            self.mlp = _SwiGLU(cfg) if cfg.use_swiglu else _gelu_mlp(D, cfg.mlp_hidden, D)


class CodonGPT(nn.Module):
    """Parameters of one CodonGPT, initialized with the JAX ``init`` distributions.

    torch's defaults already match them: U(±1/√fan_in) for linear weights
    and biases, N(0, 1) embeddings, unit/zero layer norms. The offset heads
    start as identities and shape guidance as a no-op, as in JAX.
    """

    def __init__(self, cfg: CodonGPTConfig):
        super().__init__()
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


def param_count(model: nn.Module) -> int:
    """Number of parameter elements: the JAX ``param_count`` of the same
    model's tree (a fused QKV linear holds exactly the three it replaces)."""
    return int(sum(p.numel() for p in model.parameters()))


# JAX block-linear names of each group (``training/lora.py`` targets)
ATTN_LINEARS = ("query", "key", "value", "proj")
MLP_LINEARS = ("fc", "proj", "w_gate", "w_up", "w_down")
_GELU_MLP_INDEX = {"fc": 0, "proj": 2}


def block_linears(block: Block, cfg: CodonGPTConfig, *,
                  with_qkv: bool = False) -> dict[tuple[str, str], nn.Module]:
    """The block's linears by their JAX (group, name), e.g. ("attn", "query")
    or ("mlp", "fc"). With ``fused_qkv`` the query, key and value entries
    are absent: their weights are rows of ``attn.qkv``, which ``with_qkv``
    adds as ("attn", "qkv"). A MoE block's expert bank is no linear: it has
    attention entries only."""
    out = {("attn", "proj"): block.attn.proj}
    if not cfg.fused_qkv:
        out.update({("attn", n): getattr(block.attn, n) for n in ("query", "key", "value")})
    elif with_qkv:
        out[("attn", "qkv")] = block.attn.qkv
    if cfg.moe_experts:
        return out
    if cfg.use_swiglu:
        out.update({("mlp", n): getattr(block.mlp, n) for n in ("w_gate", "w_up", "w_down")})
    else:
        out.update({("mlp", n): block.mlp[i] for n, i in _GELU_MLP_INDEX.items()})
    return out


def set_block_linear(block: Block, cfg: CodonGPTConfig, group: str, name: str,
                     linear: nn.Module) -> None:
    """Put ``linear`` in ``block`` at the JAX (group, name) place, or at
    ("attn", "qkv") for the fused attention linear."""
    parent = block.attn if group == "attn" else block.mlp
    if group == "mlp" and not cfg.use_swiglu:
        parent[_GELU_MLP_INDEX[name]] = linear
    else:
        setattr(parent, name, linear)


def attach_lora(model: CodonGPT, targets, rank: int) -> None:
    """Give every block a zero ``LoRA`` of ``rank`` on each JAX (group, name)
    of ``targets``; a fused QKV's query, key and value adapters go to
    ``attn.qkv_lora``."""
    cfg = model.cfg
    kv_dim = cfg.kv_heads * cfg.head_dim
    fan_out = {"query": cfg.n_embd, "key": kv_dim, "value": kv_dim}
    if cfg.moe_experts and any(group == "mlp" for group, _ in targets):
        raise ValueError(
            "LoRA mlp targets are unsupported on MoE models — expert "
            "banks are excluded from adaptation (use targets='attn')")
    for block in model.blocks:
        linears = block_linears(block, cfg)
        fused = {}
        if any(isinstance(m, Int8Linear) for m in block.modules()):
            raise ValueError(
                "cannot attach LoRA to int8-quantized weights — fine-tune "
                "the float checkpoint, merge, then quantize")
        for group, name in targets:
            if (group, name) in linears:
                lin = linears[(group, name)]
                lin.lora = LoRA(lin.in_features, lin.out_features, rank)
            elif cfg.fused_qkv and group == "attn" and name in fan_out:
                fused[name] = LoRA(cfg.n_embd, fan_out[name], rank)
            else:
                raise ValueError(f"the model has no block linear {group}/{name}")
        if fused:
            if set(fused) != set(fan_out):
                raise ValueError("a fused QKV takes adapters on all of query, key "
                                 f"and value, not {sorted(fused)}")
            block.attn.qkv_lora = nn.ModuleDict({n: fused[n] for n in fan_out})
    model.to(model.tok_emb.weight.device)


# --- Forward pieces ----------------------------------------------------------


def _linear(lin: nn.Module, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    """``x @ W + b`` in x's dtype, with the float32 weights cast at use,
    plus the linear's LoRA delta when it has one. An ``Int8Linear``
    computes ``(x @ w_q.T) * scale + b``, the int8 weight converted at use.
    Under tensor parallelism the linear's ``tp_index`` picks this rank's
    heads of the int8 weight, which the rules replicate; ``bias`` False
    leaves the bias to the caller (a row-parallel one adds it after the
    reduction)."""
    tp_index = getattr(lin, "tp_index", None)
    if isinstance(lin, Int8Linear):
        w_q, scale = lin.w_q, lin.scale
        if tp_index is not None:
            kind, idx = tp_index
            if kind == "col":
                w_q, scale = tpl.take(w_q, 0, idx), tpl.take(scale, 0, idx)
            else:
                w_q = tpl.take(w_q, 1, idx)
        y = torch.matmul(x, w_q.to(x.dtype).t()) * scale.to(x.dtype)
        if bias and lin.bias is not None:
            y = y + lin.bias.to(x.dtype)
        return y
    y = torch.matmul(x, lin.weight.to(x.dtype).t())
    if bias and lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    lora = lin._modules.get("lora")
    if lora is not None:
        y = y + lora.delta(x, tp_index)
    return y


def _row_linear(lin: nn.Module, x: torch.Tensor, tp, seq: bool) -> torch.Tensor:
    """A row-parallel linear: this rank's partial product, summed over the
    model axis (reduce-scattered on T under sequence parallelism), then
    the bias, which the rules replicate."""
    if tp is None or getattr(lin, "tp_index", None) is None:
        return _linear(lin, x)
    y = tpl.exit_(_linear(lin, x, bias=False), tp, seq)
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


def _qkv(block: Block, x: torch.Tensor, cfg: CodonGPTConfig, *, seq: bool = False):
    """(B, T, C) → q (B, Hq, T, D), k and v (B, Hkv, T, D). Under tensor
    parallelism ``cfg`` is this rank's (``tp_local_config``): its heads
    only, the input entering through a column-parallel entry (an all-gather
    on T when ``seq``, the stream split over the sequence)."""
    x = tpl.enter(x, getattr(block, "tp", None), seq)
    B, T, _ = x.shape
    hd = cfg.head_dim
    attn = block.attn
    if hasattr(attn, "qkv"):
        c_q = cfg.n_head * hd
        c_kv = cfg.kv_heads * hd
        qkv = _linear(attn.qkv, x)
        adapters = attn._modules.get("qkv_lora")
        if adapters is not None:
            # per-projection adapters beside the fused base product
            qkv = qkv + torch.cat([adapters[n].delta(x) for n in ("query", "key", "value")],
                                  dim=-1)
        q, k, v = torch.split(qkv, [c_q, c_kv, c_kv], dim=-1)
    else:
        q, k, v = _linear(attn.query, x), _linear(attn.key, x), _linear(attn.value, x)
    q = q.reshape(B, T, cfg.n_head, hd).transpose(1, 2)
    k = k.reshape(B, T, cfg.kv_heads, hd).transpose(1, 2)
    v = v.reshape(B, T, cfg.kv_heads, hd).transpose(1, 2)
    return q, k, v


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
             tp=None) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``generator`` (JAX:
    ``bernoulli(1 - rate)``, kept values scaled by 1/(1 - rate)). With
    ``tp`` (``x`` this rank's slice of the sequence) the mask is drawn for
    the whole sequence and sliced, so the draws match the unsplit stream's."""
    shape = list(x.shape)
    if tp is not None:
        shape[1] *= tp.size
    keep = torch.rand(shape, generator=generator, device=x.device) < (1.0 - rate)
    if tp is not None:
        keep = keep.chunk(tp.size, dim=1)[tp.rank]
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _dropout_on(cfg: CodonGPTConfig, train: bool, generator) -> bool:
    return train and generator is not None and cfg.dropout > 0.0


def moe_route(block: Block, cfg: CodonGPTConfig, ht: torch.Tensor, *, capped: bool,
              with_aux: bool = True, dp=None, rows: int | None = None) -> dict:
    """The router of a MoE block over the (N, D) tokens ``ht``: its float32
    ``probs`` (N, E), the top-k ``gate_idx`` and renormalized ``gate_vals``
    (N, k), each choice's slot ``pos`` in its expert's buffer (N, k; granted
    in rank-major, then token, priority), ``keep`` (pos < the capacity
    ``C``) and the load-balancing ``aux`` (None without ``with_aux``).

    ``C`` is ``max(1, ceil(cf · k · N / E))`` over the N tokens of the whole
    flattened microbatch when ``capped`` (training), N (dropless) otherwise,
    in Python floats as JAX computes it (``codon_gpt.py:312``).

    The router runs in float32 whatever the compute dtype, as JAX's
    ``ht.astype(f32) @ router.w``. Ties go to the lower expert index, as
    ``jax.lax.top_k`` puts them: a stable descending sort of the
    probabilities, no value changed.

    With ``dp`` (a ``DPContext``; ``ht`` this rank's ``rows`` rows of the
    global microbatch, each row ``N / rows`` tokens) the routing is the
    global microbatch's, as JAX's under GSPMD: ``_route_global``.
    """
    N = ht.shape[0]
    E = cfg.moe_experts
    k = min(cfg.moe_top_k, E)
    probs = torch.softmax(torch.matmul(ht.float(), block.router.w), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], order[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if dp is not None:
        return _route_global(cfg, probs, gate_idx, gate_vals, dp, rows, capped=capped,
                             with_aux=with_aux)
    C = max(1, math.ceil(cfg.moe_capacity_factor * k * N / E)) if capped else N
    aux = None
    if with_aux:  # Switch aux E · Σ_e f_e · p_e over all N tokens, pads included
        top1 = F.one_hot(gate_idx[:, 0], E).float()
        aux = E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
    # exclusive running count per expert over the k·N choices, rank-major: an
    # (E, k·N) one-hot scanned along its rows (a scan down 4 columns of k·N
    # takes ~1000x longer on the card)
    choice = gate_idx.t().reshape(1, k * N)
    flat = (choice == torch.arange(E, device=ht.device)[:, None]).to(torch.int32)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).gather(0, choice)
    pos = pos.view(k, N).t()
    return {"probs": probs, "gate_idx": gate_idx, "gate_vals": gate_vals, "pos": pos,
            "keep": pos < C, "C": C, "aux": aux}


def _route_global(cfg: CodonGPTConfig, probs, gate_idx, gate_vals, dp, rows: int, *,
                  capped: bool, with_aux: bool) -> dict:
    """``moe_route``'s slots, capacity and router loss over the global
    microbatch of a data-parallel step, from this rank's ``rows`` rows.

    Rank r of n holds the global rows ``r, r + n, ...`` (``EpochPlan``'s
    strided split), padded with all-PAD rows to equal shares; a row whose
    global index reaches ``dp.rows`` is such padding, not in JAX's batch: it
    neither routes, nor counts toward N, nor enters the router loss. Every
    rank gathers each row's count of choices by (choice rank, expert), a
    few hundred bytes, and takes a choice's slot as JAX's rank-major scan
    does: the choices of lower ranks over the whole microbatch, then those
    of its rank in the global rows before its own, then in its row before
    its token. ``C`` spans the ``dp.rows`` rows. The router loss uses the
    global means of the top-1 assignments and the probabilities, from sums
    over the data axis that carry their gradient (``sum_with_grad``); each
    rank returns its share, 1/n of it, so the ranks' losses sum to it once.
    ``valid`` marks the tokens of the rows in the global microbatch.
    """
    E = cfg.moe_experts
    n_local, k = gate_idx.shape
    T = n_local // rows
    n, r = dp.size, dp.rank
    g_rows = dp.rows if dp.rows is not None else rows * n
    global_row = r + n * torch.arange(rows, device=probs.device)
    valid = (global_row < g_rows).repeat_interleave(T)  # (N_local,)
    N = g_rows * T
    C = max(1, math.ceil(cfg.moe_capacity_factor * k * N / E)) if capped else N
    experts = torch.arange(E, device=probs.device)
    # (rows, k, E, T): this rank's choices one-hot by expert, padding rows empty
    oh = ((gate_idx[:, :, None] == experts) & valid[:, None, None]).to(torch.int32)
    oh = oh.view(rows, T, k, E).permute(0, 2, 3, 1).contiguous()
    counts = dp.gather(oh.sum(dim=-1))  # (n, rows, k, E)
    counts = counts.transpose(0, 1).reshape(rows * n, k, E)  # global row order
    total = counts.sum(dim=0)
    before_rank = torch.cumsum(total, dim=0) - total  # (k, E): lower choice ranks
    before_row = (torch.cumsum(counts, dim=0) - counts)[global_row]  # (rows, k, E)
    within = torch.cumsum(oh, dim=-1, dtype=torch.int32) - oh  # earlier tokens of the row
    pos = (before_rank[None, :, :, None] + before_row[..., None] + within)
    idx = gate_idx.view(rows, T, k).permute(0, 2, 1)[:, :, None, :]  # (rows, k, 1, T)
    pos = pos.gather(2, idx).squeeze(2).permute(0, 2, 1).reshape(n_local, k)
    aux = None
    if with_aux:
        w = valid[:, None].float()
        top1 = F.one_hot(gate_idx[:, 0], E).float()
        sums = dp.sum_with_grad(torch.cat([(top1 * w).sum(dim=0), (probs * w).sum(dim=0)]))
        aux = E * torch.sum((sums[:E] / N) * (sums[E:] / N)) / n
    return {"probs": probs, "gate_idx": gate_idx, "gate_vals": gate_vals, "pos": pos,
            "keep": (pos < C) & valid[:, None], "C": C, "aux": aux, "valid": valid}


def _span(name: str):
    """A profiler range named ``name`` while ``torch.profiler`` records, else
    nothing (``training/profile_step.py --moe`` splits a group's device
    time by these ranges)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _moe_mlp(block: Block, cfg: CodonGPTConfig, h: torch.Tensor, *, capped: bool,
             with_aux: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """GShard top-k routed expert MLP of (B, T, D) ``h``: ``(y, aux)``, JAX
    ``_moe_mlp``'s contract (``codon_gpt.py:285-353``); the decode paths,
    which drop the router loss, skip it (``with_aux=False``: aux is None).

    Each kept choice's token row goes to row ``expert · C + pos`` of an
    (E·C, D) buffer (an index write; a dropped choice goes to one spare row
    that is cut off), the experts run as batched matmuls over E, and each
    token gathers its kept choices' rows back, weighted by its gates in the
    compute dtype and summed in float32: the function of JAX's one-hot
    dispatch and combine einsums, whose sums have one nonzero term each. A
    dropped choice contributes 0, so the residual carries the token.

    Under a data mesh (``block.moe_dp``, set by the training step) a capped
    layer routes over the global microbatch (``moe_route``). Under expert
    parallelism (``block.mlp.experts``: this rank's first expert and count,
    ``parallel/tensor_parallel.py::shard_model``) every rank routes every
    token with the replicated router, writes only the choices bound for its
    experts into an (E/ep·C, D) buffer, runs its experts, and gathers and
    gate-weights only their rows: ``y`` is then its float32 partial sum,
    which the caller sums over the model axis and casts (``block_epilogue``),
    and the router loss, whole on every rank, carries 1/ep of its gradient
    on each, so that the model axis's sum of the router's and the input's
    gradients (``tp_partial_grad``, the entry's all-reduce) counts it once
    beside the combine's terms, which each rank gives for its experts only.
    """
    B, T, D = h.shape
    N = B * T
    E = cfg.moe_experts
    dt = h.dtype
    ht = h.reshape(N, D)
    dp = getattr(block, "moe_dp", None) if capped else None
    with _span("moe_router"):
        r = moe_route(block, cfg, ht, capped=capped, with_aux=with_aux, dp=dp, rows=B)
    C, k = r["C"], r["gate_idx"].shape[1]
    first, local = getattr(block.mlp, "experts", None) or (0, E)
    with _span("moe_dispatch"):
        mine = r["keep"]
        if local < E:
            mine = mine & (r["gate_idx"] >= first) & (r["gate_idx"] < first + local)
        slot = torch.where(mine, (r["gate_idx"] - first) * C + r["pos"],
                           local * C).t().reshape(k * N)
        xin = ht.repeat(k, 1)  # rank-major: row r·N + n is token n
        xe = torch.index_put(ht.new_zeros(local * C + 1, D), (slot,), xin)[: local * C]
        xe = xe.view(local, C, D)
    mlp = block.mlp
    with _span("moe_experts"):
        if cfg.use_swiglu:
            gate = torch.bmm(xe, mlp.w_gate.w.to(dt))
            up = torch.bmm(xe, mlp.w_up.w.to(dt))
            ye = torch.bmm(F.silu(gate) * up, mlp.w_down.w.to(dt))
        else:
            mid = F.gelu(torch.bmm(xe, mlp.fc.w.to(dt)) + mlp.fc.b.to(dt)[:, None, :])
            ye = torch.bmm(mid, mlp.proj.w.to(dt)) + mlp.proj.b.to(dt)[:, None, :]
    with _span("moe_combine"):
        rows = torch.cat([ye.reshape(local * C, D), ye.new_zeros(1, D)])[slot]
        gates = r["gate_vals"].to(dt).t().reshape(k * N, 1)
        y = (rows.float() * gates.float()).view(k, N, D).sum(dim=0)
    aux = r["aux"]
    if local < E:  # a float32 partial sum over this rank's experts
        if aux is not None:
            aux = aux.detach() + (aux - aux.detach()) * (local / E)
        return y.view(B, T, D), aux
    return y.to(dt).view(B, T, D), aux


def block_epilogue(block: Block, cfg: CodonGPTConfig, x: torch.Tensor,
                   y_attn: torch.Tensor, *, train: bool = False,
                   generator: torch.Generator | None = None, capped: bool | None = None,
                   return_moe_aux: bool = False, seq: bool = False):
    """Post-attention half of a block, shared by every path: the output
    projection's residual add, LN2, and the (SwiGLU | GELU | MoE) MLP
    residual, whose output takes dropout in training.

    A MoE MLP binds its capacity when ``capped`` (default: ``train``) and
    routes dropless otherwise. ``return_moe_aux`` returns ``(x, aux)``, aux
    the router loss (None for a dense block).

    Under tensor parallelism the projection and the MLP's down linear are
    row-parallel exits and its up linears column-parallel entries; an MLP
    whose hidden width the degree does not divide runs whole on every rank.
    With ``seq`` the residual ``x`` is this rank's slice of the sequence.
    An expert-parallel MoE MLP enters and leaves as a split dense one, its
    float32 partial sums reduced before the cast."""
    tp = getattr(block, "tp", None)
    x = x + _row_linear(block.attn.proj, y_attn, tp, seq)
    h = _layer_norm(block.ln2, x)
    mlp = block.mlp
    moe_aux = None
    if cfg.moe_experts:
        split = tp is not None and getattr(mlp, "experts", None) is not None
    else:
        split = tp is not None and getattr(
            mlp.w_up if cfg.use_swiglu else mlp[0], "tp_index", None) is not None
    if split:
        h = tpl.enter(h, tp, seq)
    elif tp is not None and seq:
        h = tpl.gather_seq_replicated(h, tp)
    if cfg.moe_experts:
        m, moe_aux = _moe_mlp(block, cfg, h, capped=train if capped is None else capped,
                              with_aux=return_moe_aux)
        if split:
            m = tpl.exit_(m, tp, seq).to(h.dtype)
    elif cfg.use_swiglu:
        m = F.silu(_linear(mlp.w_gate, h)) * _linear(mlp.w_up, h)
        m = _row_linear(mlp.w_down, m, tp, seq) if split else _linear(mlp.w_down, m)
    else:
        m = F.gelu(_linear(mlp[0], h))
        m = _row_linear(mlp[2], m, tp, seq) if split else _linear(mlp[2], m)
    if tp is not None and seq and not split:
        m = tpl.split_seq(m, tp)
    if _dropout_on(cfg, train, generator):
        m = _dropout(m, cfg.dropout, generator, tp if seq else None)
    x = x + m
    return (x, moe_aux) if return_moe_aux else x


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


def _block_apply(block: Block, cfg: CodonGPTConfig, x: torch.Tensor, *, segment_ids,
                 attention_window, rope, drop: bool, generator, capped: bool = False,
                 seq: bool = False):
    """One block of the training forward: LN1, QKV, attention, epilogue.
    Returns ``(x, moe_aux)``; a MoE MLP binds its capacity when ``capped``
    (the true training flag, whether or not dropout acts). ``seq``: ``x``
    is this rank's slice of the sequence (sequence parallelism)."""
    h = _layer_norm(block.ln1, x)
    q, k, v = _qkv(block, h, cfg, seq=seq)
    B, T = q.shape[0], q.shape[2]
    if rope is not None:
        q, k = apply_rope(q, k, *rope)
    seed = (torch.randint(0, 2**31 - 1, (1,), generator=generator, device=x.device,
                          dtype=torch.int32) if drop else None)
    # a tensor-parallel rank's heads drop as those heads of the whole model
    tp = getattr(block, "tp", None)
    Hq = q.shape[1]
    heads = (tp.rank * Hq, tp.size * Hq) if tp is not None else None
    y = attention(q, k, v, segment_ids=segment_ids, attention_window=attention_window,
                  dropout_rate=cfg.dropout if drop else 0.0, seed=seed,
                  impl=cfg.attention_impl, dropout_heads=heads)
    return block_epilogue(block, cfg, x, y.transpose(1, 2).reshape(B, T, -1), train=drop,
                          generator=generator, capped=capped, return_moe_aux=True, seq=seq)


def _remat_block(block: Block, cfg: CodonGPTConfig, x: torch.Tensor, generator,
                 *, drop: bool, **kw):
    """``_block_apply`` under ``torch.utils.checkpoint``, ``(x, moe_aux)``:
    its activations are recomputed in the backward instead of kept. Both
    passes draw from a copy of ``generator`` taken at the block's start, so
    the recomputed dropout masks and attention seed are the first pass's;
    ``generator`` then continues from where the first pass left its copy.
    The recomputed MoE routing repeats the first pass's from the same
    inputs."""
    start = generator.get_state() if drop else None
    end: list[torch.Tensor] = []

    def run(h):
        gen = None
        if drop:
            gen = torch.Generator(device=h.device)
            gen.set_state(start)
        out, aux = _block_apply(block, cfg, h, drop=drop, generator=gen, **kw)
        if drop and not end:
            end.append(gen.get_state())
        return out if aux is None else (out, aux)

    out = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                            preserve_rng_state=False)
    if drop:
        generator.set_state(end[0])
    return out if cfg.moe_experts else (out, None)


def _local_cfg(model: CodonGPT, cfg: CodonGPTConfig) -> CodonGPTConfig:
    """``cfg``, or under tensor parallelism this rank's (``tp_local_config``)."""
    tp = getattr(model, "tp", None)
    return cfg if tp is None else tpl.tp_local_config(cfg, tp.size)


def _sequence_parallel(model: CodonGPT, idx: torch.Tensor):
    """The model-axis context when the forward runs sequence-parallel:
    ``residual_sharding`` asks for it and the degree divides T."""
    tp = getattr(model, "tp", None)
    if tp is None or not tp.sequence_parallel or idx.shape[1] % tp.size:
        return None
    return tp


def _rope_for(cfg: CodonGPTConfig, idx: torch.Tensor):
    if not cfg.use_rope:
        return None
    return rope_cos_sin(idx.shape[1], cfg.head_dim, cfg.rope_base, cfg.dtype, idx.device)


def embed_stream(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor,
                 shape_embeddings: torch.Tensor | None = None, *, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """The residual stream entering the blocks: the embedding (its dropout
    in training), split over T under sequence parallelism."""
    x = _embed(model, cfg, idx, shape_embeddings, train=_dropout_on(cfg, train, generator),
               generator=generator)
    seq_tp = _sequence_parallel(model, idx)
    return tpl.split_seq(x, seq_tp) if seq_tp is not None else x


def run_blocks(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor, x: torch.Tensor, *,
               train: bool = False, generator: torch.Generator | None = None,
               attention_window: int | None = None) -> tuple[torch.Tensor, list]:
    """``model.blocks`` in turn over the stream ``x`` of the tokens ``idx``
    (remat per block under ``use_checkpoint``): the stream and each block's
    router loss (None for a dense block). A pipeline stage runs its own
    blocks through it (``parallel/pipeline.py``)."""
    segment_ids = (
        segment_ids_from_tokens(idx, cfg.sep_id) if cfg.sep_id is not None else None
    )
    drop = _dropout_on(cfg, train, generator)
    rope = _rope_for(cfg, idx)
    seq = _sequence_parallel(model, idx) is not None
    lcfg = _local_cfg(model, cfg)
    moe_aux = []
    for block in model.blocks:
        kw = dict(segment_ids=segment_ids, attention_window=attention_window, rope=rope,
                  drop=drop, capped=train, seq=seq)
        if cfg.use_checkpoint and torch.is_grad_enabled():
            x, aux = _remat_block(block, lcfg, x, generator, **kw)
        else:
            x, aux = _block_apply(block, lcfg, x, generator=generator, **kw)
        moe_aux.append(aux)
    return x, moe_aux


def final_stream(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The stream after the blocks, whole again under sequence parallelism,
    through the final layer norm."""
    seq_tp = _sequence_parallel(model, idx)
    if seq_tp is not None:
        x = tpl.gather_seq_replicated(x, seq_tp)
    return _layer_norm(model.ln_f, x)


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
    ``(logits, loss, aux)``; aux carries ``termination_logits``,
    ``offset_logits`` ({offset: logits}) and ``moe_aux_loss`` (the router
    loss, the mean over layers) when those heads or experts exist, as the
    JAX ``forward`` does. A MoE MLP binds its capacity with ``train``. ``loss`` is the torch-semantics cross-entropy against
    ``targets`` (pad id 0 ignored, ``cfg.label_smoothing`` and
    ``cfg.loss_weights``), or None without targets.

    Dropout acts only with ``train`` and a ``generator`` on idx's device,
    as the JAX forward drops only with ``train`` and a key. Runs under
    autograd: the serving and generation entry points call it under
    ``torch.no_grad``.

    Under tensor parallelism (``model.tp``, ``parallel/tensor_parallel.py``)
    each rank runs its heads and returns the whole logits; with sequence
    parallelism the residual stream between the embedding and the final
    norm is split over T (JAX's ``_constrain_residual``).
    """
    x = embed_stream(model, cfg, idx, shape_embeddings, train=train, generator=generator)
    x, moe_aux = run_blocks(model, cfg, idx, x, train=train, generator=generator,
                            attention_window=attention_window)
    x = final_stream(model, cfg, idx, x)
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
    if cfg.moe_experts:
        aux["moe_aux_loss"] = torch.stack(moe_aux).mean()
    if cfg.termination_aux:
        aux["termination_logits"] = _linear(model.termination_head, x)
    if cfg.multi_offset_targets:
        aux["offset_logits"] = {
            o: _offset_logits(model, cfg, x, o) for o in cfg.multi_offset_targets}
    return logits, loss, aux


def hidden_states(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor, *,
                  shape_embeddings: torch.Tensor | None = None,
                  attention_window: int | None = None) -> list:
    """Canonical causal states at the embedding, each block and the final
    norm: ``[(0, emb), (1, h1), ..., (L, hL), ("final", ln_f(hL))]``, from
    the inference forward one block at a time (no dropout; a MoE block
    routes dropless), attention by ``cfg.attention_impl`` (the flash
    forward on the card under ``"flash"``). Runs under autograd: the
    extraction entry points call it under ``torch.no_grad``."""
    segment_ids = (
        segment_ids_from_tokens(idx, cfg.sep_id) if cfg.sep_id is not None else None
    )
    x = _embed(model, cfg, idx, shape_embeddings)
    rope = _rope_for(cfg, idx)
    out = [(0, x)]
    lcfg = _local_cfg(model, cfg)
    for layer, block in enumerate(model.blocks):
        x, _ = _block_apply(block, lcfg, x, segment_ids=segment_ids,
                            attention_window=attention_window, rope=rope, drop=False,
                            generator=None)
        out.append((layer + 1, x))
    out.append(("final", _layer_norm(model.ln_f, x)))
    return out


def forward_hidden(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor,
                   **kwargs) -> torch.Tensor:
    """Final-norm hidden states, the canonical embedding-extraction output."""
    return hidden_states(model, cfg, idx, **kwargs)[-1][1]


def attention_maps(model: CodonGPT, cfg: CodonGPTConfig, idx: torch.Tensor, *,
                   attention_window: int | None = None) -> list[torch.Tensor]:
    """Per-layer attention probabilities (B, H, T, T) under the causal,
    window and ``<SEP>``-segment mask, from the einsum attention (a masked
    entry is exactly 0); the blocks continue through ``block_epilogue``
    (dropless for MoE)."""
    segment_ids = (
        segment_ids_from_tokens(idx, cfg.sep_id) if cfg.sep_id is not None else None
    )
    x = _embed(model, cfg, idx)
    rope = _rope_for(cfg, idx)
    T = idx.shape[1]
    mask = structure_mask(T, T, window=attention_window, segment_ids=segment_ids,
                          device=idx.device)
    maps = []
    lcfg = _local_cfg(model, cfg)
    for block in model.blocks:
        h = _layer_norm(block.ln1, x)
        q, k, v = _qkv(block, h, lcfg)
        if rope is not None:
            q, k = apply_rope(q, k, *rope)
        y, probs = sdpa(q, k, v, mask=mask, return_probs=True)
        maps.append(probs)
        x = block_epilogue(block, lcfg, x, y.transpose(1, 2).reshape(*x.shape[:2], -1))
    return maps


__all__ = [
    "ATTN_LINEARS",
    "Block",
    "CodonGPT",
    "ExpertLinear",
    "Int8Linear",
    "LoRA",
    "MLP_LINEARS",
    "MoEMLP",
    "Router",
    "attach_lora",
    "attention_maps",
    "block_linears",
    "apply_rope",
    "block_epilogue",
    "embed_stream",
    "final_stream",
    "forward",
    "forward_hidden",
    "hidden_states",
    "moe_route",
    "param_count",
    "rope_cos_sin",
    "rotate_half",
    "run_blocks",
    "set_block_linear",
]
