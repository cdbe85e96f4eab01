"""Model configuration dataclass (twin of ``genomics_lm_tpu/models/config.py``).

Same fields, same ``__post_init__`` checks and the same ``from_run_config``
keys as the JAX config, so one run config builds both. ``dtype`` returns a
``torch.dtype``. The TPU layout levers ``pad_vocab_lanes``, ``scan_unroll``,
``flash_block_q``/``flash_block_k``, ``residual_sharding`` and
``expert_sharding`` are accepted and have no effect here: they change how
XLA lays the same math out on a TPU, not the math.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class CodonGPTConfig:
    vocab_size: int
    block_size: int
    n_layer: int = 3
    n_head: int = 4
    n_embd: int = 256
    dropout: float = 0.1
    label_smoothing: float = 0.0
    sep_id: int | None = 3
    tie_embeddings: bool = True
    n_kv_head: int | None = None  # None → full MHA; else GQA group count
    termination_aux: bool = False
    termination_n_classes: int = 5
    multi_offset_targets: tuple[int, ...] = ()
    use_swiglu: bool = False
    use_rope: bool = False
    rope_base: float = 10000.0
    use_shape_guidance: bool = False
    loss_weights: tuple[float, ...] | None = None  # per-token CE weights
    moe_experts: int = 0  # MoE is not ported: > 0 raises where a model is built
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    use_checkpoint: bool = False
    pad_vocab_lanes: bool = False  # TPU layout lever: no effect here
    attention_impl: str = "xla"  # "xla" (einsum) | "flash" (the CUDA flash and decode kernels)
    compute_dtype: str = "float32"  # "bfloat16" for serving
    fused_qkv: bool = False  # one (C, C+2*Ckv) linear instead of three
    scan_unroll: int = 1  # TPU layout lever: no effect here
    flash_block_q: int = 128  # TPU layout lever: no effect here
    flash_block_k: int = 128
    residual_sharding: tuple[str | None, ...] | None = None  # no effect here
    expert_sharding: str | None = None  # no effect here

    def __post_init__(self):
        if self.n_embd % self.n_head != 0:
            raise ValueError("n_embd must be divisible by n_head")
        kv = self.n_kv_head
        if kv is not None and kv > 0 and self.n_head % kv != 0:
            raise ValueError("n_head must be divisible by n_kv_head for GQA")
        if self.multi_offset_targets:
            object.__setattr__(
                self,
                "multi_offset_targets",
                tuple(sorted({int(t) for t in self.multi_offset_targets})),
            )
        if self.loss_weights is not None:
            object.__setattr__(
                self, "loss_weights", tuple(float(w) for w in self.loss_weights)
            )
        if self.residual_sharding is not None:
            object.__setattr__(
                self, "residual_sharding", tuple(self.residual_sharding)
            )
        if self.moe_experts:
            if self.moe_experts < 2:
                raise ValueError("moe_experts must be 0 (dense) or >= 2")
            if not (1 <= self.moe_top_k <= self.moe_experts):
                raise ValueError("moe_top_k must be in [1, moe_experts]")
            if self.moe_capacity_factor <= 0:
                raise ValueError("moe_capacity_factor must be positive")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_head
        return self.n_head if (kv is None or kv <= 0 or kv > self.n_head) else kv

    @property
    def mlp_hidden(self) -> int:
        # SwiGLU uses the 8/3 rule of the reference (model_tiny_gpt.py:50).
        return int(8 * self.n_embd // 3) if self.use_swiglu else 4 * self.n_embd

    @property
    def dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.compute_dtype]
        except KeyError:
            raise ValueError(
                f"unsupported compute_dtype {self.compute_dtype!r}; "
                f"expected one of {sorted(_DTYPES)}") from None

    @property
    def uniform_loss_weights(self) -> bool:
        return self.loss_weights is None or all(w == 1.0 for w in self.loss_weights)

    def replace(self, **kwargs) -> "CodonGPTConfig":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        """Checkpoint-meta spec (same keys as reference TinyGPT.to_dict)."""
        return {
            "vocab_size": int(self.vocab_size),
            "block_size": int(self.block_size),
            "n_layer": int(self.n_layer),
            "n_head": int(self.n_head),
            "n_embd": int(self.n_embd),
            "dropout": float(self.dropout),
            "sep_mask_enabled": self.sep_id is not None,
            "tie_embeddings": bool(self.tie_embeddings),
            "n_kv_head": self.n_kv_head,
            "use_sdpa": self.attention_impl != "xla",
            "termination_aux": bool(self.termination_aux),
            "termination_n_classes": int(self.termination_n_classes),
            "multi_offset_targets": list(self.multi_offset_targets),
            "use_swiglu": bool(self.use_swiglu),
            "use_rope": bool(self.use_rope),
            "use_shape_guidance": bool(self.use_shape_guidance),
            **(
                {
                    "moe_experts": int(self.moe_experts),
                    "moe_top_k": int(self.moe_top_k),
                    "moe_capacity_factor": float(self.moe_capacity_factor),
                    "moe_aux_weight": float(self.moe_aux_weight),
                }
                if self.moe_experts
                else {}
            ),
        }

    @classmethod
    def from_run_config(cls, cfg: dict) -> "CodonGPTConfig":
        """Build from a flat YAML run config (reference key names)."""
        n_embd = cfg.get("n_embd")
        if n_embd is None and "d_head" in cfg:
            n_embd = int(cfg["d_head"]) * int(cfg["n_head"])
        kwargs = dict(
            vocab_size=int(cfg["vocab_size"]),
            block_size=int(cfg["block_size"]),
            n_layer=int(cfg.get("n_layer", 3)),
            n_head=int(cfg.get("n_head", 4)),
            n_embd=int(n_embd if n_embd is not None else 256),
            dropout=float(cfg.get("dropout", 0.1)),
            label_smoothing=float(cfg.get("label_smoothing", 0.0)),
            sep_id=cfg.get("sep_id", 3),
            tie_embeddings=bool(cfg.get("tie_embeddings", True)),
            n_kv_head=cfg.get("n_kv_head"),
            termination_aux=bool(cfg.get("termination_aux", False)),
            termination_n_classes=int(cfg.get("termination_n_classes", 5)),
            multi_offset_targets=tuple(cfg.get("multi_offset_targets", ()) or ()),
            use_swiglu=bool(cfg.get("use_swiglu", False)),
            use_rope=bool(cfg.get("use_rope", False)),
            use_shape_guidance=bool(cfg.get("use_shape_guidance", False)),
            loss_weights=tuple(cfg["loss_weights"]) if cfg.get("loss_weights") else None,
            use_checkpoint=bool(cfg.get("use_checkpoint", False)),
            pad_vocab_lanes=bool(cfg.get("pad_vocab_lanes", False)),
            attention_impl=str(cfg.get("attention_impl", "xla")),
            compute_dtype=str(cfg.get("compute_dtype", "float32")),
            fused_qkv=bool(cfg.get("fused_qkv", False)),
            scan_unroll=int(cfg.get("scan_unroll", 1)),
            flash_block_q=int(cfg.get("flash_block_q", 128)),
            flash_block_k=int(cfg.get("flash_block_k", 128)),
            moe_experts=int(cfg.get("moe_experts", 0) or 0),
            moe_top_k=int(cfg.get("moe_top_k", 2)),
            moe_capacity_factor=float(cfg.get("moe_capacity_factor", 1.25)),
            moe_aux_weight=float(cfg.get("moe_aux_weight", 0.01)),
            expert_sharding=cfg.get("expert_sharding"),
        )
        if kwargs["sep_id"] is not None:
            kwargs["sep_id"] = int(kwargs["sep_id"])
        return cls(**kwargs)
