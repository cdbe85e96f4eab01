"""Protein-critic model stack: LM, classifier, multi-task critic, EBM (twin of
``genomics_lm_tpu/models/protein.py``).

- ``ProteinLM`` — post-LN encoder blocks (x = LN(x + MHA(x)); x = LN(x +
  FFN(x)), exact-GELU FFN), learned positions sliced to T, an untied head
  after the final layer norm, causal.
- ``ProteinClassifier`` — the bidirectional backbone under a key-padding
  mask, classified from the BOS position.
- ``MultiTaskProteinCritic`` — mean or attention pooling, a shared latent
  (Linear + LN + GELU + dropout) and one linear head per task;
  ``extract_latent`` is the EBM's and the Langevin sampler's entry point
  (``inputs_embeds`` may be a float tensor that requires grad).
- ``ProteinLatentEBM`` — a 3-layer GELU MLP energy head.

The modules hold the parameters, the functions below (JAX's, by name) run
them. They hold their parameters under the JAX tree's own names and
layouts: a linear is ``w`` (fan_in, fan_out) and ``b``, a layer norm
``scale`` and ``bias``, blocks a list. So a parameter's ``state_dict`` key
is its JAX path with dots (``backbone.blocks.0.attn.query.w`` is
``backbone/blocks[0]/attn/query/w``), each linear computes ``x @ w + b`` as
JAX does, and ``utils/weights.py::protein_params_from_jax`` moves a tree in
and out without a transpose.

The backbone's feature path skips the final layer norm (only the LM applies
it). The key-padding mask is ANDed with the causal one. Attention runs
through ``ops/attention.py::sdpa``, the einsum the JAX package's
``sdpa_xla`` computes outside any Pallas kernel. Attention pooling writes
-inf into the padded logits, so a row without a valid token gives NaN, as
in JAX. Dropout draws its keep masks from an explicit ``torch.Generator``
(JAX threads keys; the two streams differ, so they are compared by rate and
at rate 0), and the attention-probability dropout a Philox seed drawn from
the same generator.

``init_weights`` draws the JAX package's law (uniform linears, Xavier
query/key/value with zero bias, normal embeddings, a 0.02-normal pooling
query) from a ``torch.Generator``; a parity check loads JAX's own draw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F
from torch import nn

from genomics_lm_torch.ops.attention import sdpa


@dataclass(frozen=True)
class ProteinLMConfig:
    vocab_size: int
    n_layer: int
    n_head: int
    n_embd: int
    block_size: int
    dropout: float


@dataclass(frozen=True)
class ProteinClassifierConfig:
    vocab_size: int
    n_layer: int
    n_head: int
    n_embd: int
    block_size: int
    dropout: float
    num_classes: int = 2
    use_checkpoint: bool = False
    pooling: str = "mean"  # "mean" | "attention"
    bidirectional: bool = True

    def lm_config(self) -> ProteinLMConfig:
        return ProteinLMConfig(
            vocab_size=self.vocab_size, n_layer=self.n_layer, n_head=self.n_head,
            n_embd=self.n_embd, block_size=self.block_size, dropout=self.dropout,
        )


def load_config(path: str, config_class):
    """YAML ``model:`` sub-map → dataclass (parity: protein config loader)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    model_data = data.get("model", {})
    expected = {f.name for f in fields(config_class)}
    return config_class(**{k: v for k, v in model_data.items() if k in expected})


# --- modules in the JAX tree's layout ----------------------------------------


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` (fan_in, fan_out), as the JAX tree holds it."""

    def __init__(self, fan_in: int, fan_out: int, *, bias: bool = True,
                 xavier: bool = False) -> None:
        super().__init__()
        self.fan_in, self.fan_out, self.xavier = fan_in, fan_out, xavier
        self.w = nn.Parameter(torch.empty(fan_in, fan_out))
        self.b = nn.Parameter(torch.empty(fan_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y + self.b if self.b is not None else y

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> None:
        """JAX's ``_linear_init``: uniform in ±bound (Xavier's for q/k/v, whose
        bias is zero; 1/sqrt(fan_in) otherwise, bias likewise)."""
        if self.xavier:
            bound = math.sqrt(6.0 / (self.fan_in + self.fan_out))
        else:
            bound = 1.0 / math.sqrt(self.fan_in)
        _uniform(self.w, bound, generator)
        if self.b is not None:
            if self.xavier:
                self.b.zero_()
            else:
                _uniform(self.b, 1.0 / math.sqrt(self.fan_in), generator)


def _uniform(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)


class LayerNorm(nn.Module):
    """``(x - mean) / sqrt(var + eps) * scale + bias`` with JAX's leaf names."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class Attention(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.query = Linear(d, d, xavier=True)
        self.key = Linear(d, d, xavier=True)
        self.value = Linear(d, d, xavier=True)
        self.out = Linear(d, d)


class FeedForward(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.w1 = Linear(d, 4 * d)
        self.w2 = Linear(4 * d, d)


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (torch ``TransformerEncoderLayer``)."""

    def __init__(self, d: int) -> None:
        super().__init__()
        self.attn = Attention(d)
        self.ln1 = LayerNorm(d)
        self.ff = FeedForward(d)
        self.ln2 = LayerNorm(d)


class Backbone(nn.Module):
    def __init__(self, cfg: ProteinLMConfig) -> None:
        super().__init__()
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd))
        self.position_embedding = nn.Parameter(torch.empty(cfg.block_size, cfg.n_embd))
        self.blocks = nn.ModuleList(EncoderLayer(cfg.n_embd) for _ in range(cfg.n_layer))
        self.layer_norm = LayerNorm(cfg.n_embd)


class ProteinLM(Backbone):
    """The LM's tree is the backbone's leaves plus ``output_head``."""

    def __init__(self, cfg: ProteinLMConfig) -> None:
        super().__init__(cfg)
        self.cfg = cfg
        self.output_head = Linear(cfg.n_embd, cfg.vocab_size, bias=False)


class ProteinClassifier(nn.Module):
    def __init__(self, cfg: ProteinClassifierConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg.lm_config())
        self.classification_head = Linear(cfg.n_embd, cfg.num_classes)


class AttentionPooling(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.query = nn.Parameter(torch.empty(d))
        self.key_proj = Linear(d, d)
        self.value_proj = Linear(d, d)


class SharedLatent(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.fc = Linear(d, d)
        self.ln = LayerNorm(d)


class MultiTaskProteinCritic(nn.Module):
    """Backbone, pooling, shared latent and one head per task (sorted by name,
    as JAX's init orders them)."""

    def __init__(self, cfg: ProteinClassifierConfig, task_dims: dict[str, int]) -> None:
        super().__init__()
        self.cfg = cfg
        self.task_dims = {name: int(dim) for name, dim in sorted(task_dims.items())}
        self.backbone = Backbone(cfg.lm_config())
        self.shared_latent = SharedLatent(cfg.n_embd)
        self.heads = nn.ModuleDict(
            {name: Linear(cfg.n_embd, dim) for name, dim in self.task_dims.items()})
        if cfg.pooling == "attention":
            self.pooler = AttentionPooling(cfg.n_embd)


class ProteinLatentEBM(nn.Module):
    def __init__(self, n_embd: int = 256, hidden_dim: int = 512) -> None:
        super().__init__()
        self.fc1 = Linear(n_embd, hidden_dim)
        self.fc2 = Linear(hidden_dim, hidden_dim)
        self.fc3 = Linear(hidden_dim, 1)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every parameter of ``module`` (on the CPU) with the JAX init's law:
    the linears by ``Linear.reset``, embeddings standard normal, the pooling
    query 0.02 x normal, layer norms ones and zeros."""
    gen = torch.Generator().manual_seed(int(seed))
    for sub in module.modules():
        if isinstance(sub, Linear):
            sub.reset(gen)
        elif isinstance(sub, LayerNorm):
            sub.scale.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, Backbone):
            sub.token_embedding.copy_(torch.randn(sub.token_embedding.shape, generator=gen))
            sub.position_embedding.copy_(
                torch.randn(sub.position_embedding.shape, generator=gen))
        elif isinstance(sub, AttentionPooling):
            sub.query.copy_(0.02 * torch.randn(sub.query.shape, generator=gen))
    return module


# --- forward ------------------------------------------------------------------


def _dropout(x: torch.Tensor, rate: float, generator, train: bool) -> torch.Tensor:
    if not train or generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _encoder_layer(p: EncoderLayer, x, cfg: ProteinLMConfig, *, causal, padding_mask, train,
                   generator):
    B, T, D = x.shape
    H = cfg.n_head
    hd = D // H
    drop = train and generator is not None and cfg.dropout > 0.0

    def heads(lin):
        return lin(x).reshape(B, T, H, hd).transpose(1, 2)

    q, k, v = heads(p.attn.query), heads(p.attn.key), heads(p.attn.value)
    mask = torch.ones((B, 1, T, T), dtype=torch.bool, device=x.device)
    if causal:
        mask = mask & torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    if padding_mask is not None:
        # padding_mask True = valid token; keys at padded positions masked out
        mask = mask & padding_mask[:, None, None, :]
    seed = (torch.randint(0, 2**31 - 1, (1,), generator=generator, device=x.device,
                          dtype=torch.int32) if drop else None)
    y = sdpa(q, k, v, mask=mask, dropout_rate=cfg.dropout if drop else 0.0, seed=seed)
    y = p.attn.out(y.transpose(1, 2).reshape(B, T, D))
    x = p.ln1(x + _dropout(y, cfg.dropout, generator, train))
    h = p.ff.w2(F.gelu(p.ff.w1(x), approximate="none"))
    return p.ln2(x + _dropout(h, cfg.dropout, generator, train))


def backbone_hidden(
    backbone: Backbone,
    cfg: ProteinLMConfig,
    input_ids: torch.Tensor | None,
    *,
    causal: bool,
    padding_mask: torch.Tensor | None = None,
    train: bool = False,
    generator: torch.Generator | None = None,
    inputs_embeds: torch.Tensor | None = None,
) -> torch.Tensor:
    """Backbone hidden states, before the final layer norm (the reference's
    feature path skips ``layer_norm``)."""
    if inputs_embeds is None:
        x = backbone.token_embedding[input_ids.long()]
    else:
        x = inputs_embeds
    T = x.shape[1]
    x = x + backbone.position_embedding[:T][None]
    x = _dropout(x, cfg.dropout, generator, train)
    for block in backbone.blocks:
        x = _encoder_layer(block, x, cfg, causal=causal, padding_mask=padding_mask,
                           train=train, generator=generator)
    return x


def protein_lm_forward(model: ProteinLM, cfg: ProteinLMConfig, input_ids, *,
                       train: bool = False, generator=None) -> torch.Tensor:
    """Causal LM logits (B, T, V)."""
    x = backbone_hidden(model, cfg, input_ids, causal=True, train=train, generator=generator)
    return model.output_head(model.layer_norm(x))


def _as_bool(mask):
    return None if mask is None else mask.to(torch.bool)


def classifier_forward(model: ProteinClassifier, cfg: ProteinClassifierConfig, input_ids,
                       attention_mask=None, *, train: bool = False,
                       generator=None) -> torch.Tensor:
    """BOS-representation classification logits (B, C)."""
    if attention_mask is None:
        attention_mask = input_ids != 0
    x = backbone_hidden(model.backbone, cfg.lm_config(), input_ids, causal=False,
                        padding_mask=_as_bool(attention_mask), train=train,
                        generator=generator)
    return model.classification_head(x[:, 0, :])


def attention_pool(p: AttentionPooling, x, attention_mask=None):
    """Learned-query pooling → (pooled (B, D), weights (B, T))."""
    k = p.key_proj(x)
    v = p.value_proj(x)
    logits = (k @ p.query) / math.sqrt(k.shape[-1])
    if attention_mask is not None:
        logits = logits.masked_fill(~attention_mask.to(torch.bool), float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bt,btd->bd", weights, v), weights


def _pool(model, cfg: ProteinClassifierConfig, x, attention_mask):
    if cfg.pooling == "attention":
        return attention_pool(model.pooler, x, attention_mask)
    if attention_mask is None:
        return x.mean(dim=1), None
    m = attention_mask.to(x.dtype)[:, :, None]
    return (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0), None


def _shared_latent(p: SharedLatent, x, *, dropout, train, generator):
    h = F.gelu(p.ln(p.fc(x)), approximate="none")
    return _dropout(h, dropout, generator, train)


def multitask_forward(model: MultiTaskProteinCritic, cfg: ProteinClassifierConfig, input_ids,
                      attention_mask=None, *, train: bool = False, generator=None) -> dict:
    """Per-task logits dict (+ ``attention_weights`` under attention pooling)."""
    x = backbone_hidden(model.backbone, cfg.lm_config(), input_ids,
                        causal=not cfg.bidirectional, padding_mask=_as_bool(attention_mask),
                        train=train, generator=generator)
    pooled, attn_weights = _pool(model, cfg, x, attention_mask)
    latent = _shared_latent(model.shared_latent, pooled, dropout=cfg.dropout, train=train,
                            generator=generator)
    out = {name: head(latent) for name, head in model.heads.items()}
    if attn_weights is not None:
        out["attention_weights"] = attn_weights
    return out


def extract_latent(model: MultiTaskProteinCritic, cfg: ProteinClassifierConfig, input_ids,
                   attention_mask=None, *, inputs_embeds=None) -> torch.Tensor:
    """Continuous bottleneck latent z (B, D), without dropout."""
    x = backbone_hidden(model.backbone, cfg.lm_config(), input_ids,
                        causal=not cfg.bidirectional, padding_mask=_as_bool(attention_mask),
                        inputs_embeds=inputs_embeds)
    pooled, _ = _pool(model, cfg, x, attention_mask)
    return _shared_latent(model.shared_latent, pooled, dropout=0.0, train=False, generator=None)


def ebm_energy(ebm: ProteinLatentEBM, z: torch.Tensor, *, train: bool = False,
               generator=None, dropout: float = 0.1) -> torch.Tensor:
    """Scalar energy per latent (B,); a 3-D input is meaned over the sequence."""
    if z.ndim == 3:
        z = z.mean(dim=1)
    h = _dropout(F.gelu(ebm.fc1(z), approximate="none"), dropout, generator, train)
    h = _dropout(F.gelu(ebm.fc2(h), approximate="none"), dropout, generator, train)
    return ebm.fc3(h)[..., 0]


__all__ = [
    "AttentionPooling",
    "Backbone",
    "MultiTaskProteinCritic",
    "ProteinClassifier",
    "ProteinClassifierConfig",
    "ProteinLM",
    "ProteinLMConfig",
    "ProteinLatentEBM",
    "attention_pool",
    "backbone_hidden",
    "classifier_forward",
    "ebm_energy",
    "extract_latent",
    "init_weights",
    "load_config",
    "multitask_forward",
    "protein_lm_forward",
]
