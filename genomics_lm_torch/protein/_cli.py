"""What the protein CLIs share: the critic's config from a checkpoint's
``cfg`` with each script's defaults, and the critic loaded frozen."""

from __future__ import annotations

from genomics_lm_torch.models.protein import ProteinClassifierConfig
from genomics_lm_torch.protein.common import load_frozen, resolve_device
from genomics_lm_torch.training.checkpoints import load_checkpoint


def critic_from_checkpoint(path, device, *, pooling: str, bidirectional: bool = False):
    """(critic, cfg, payload) on ``device``: the config from the checkpoint's
    ``cfg`` (JAX's defaults for what it lacks, ``pooling`` the script's
    default), ``bidirectional`` read only where the JAX script reads it."""
    device = resolve_device(device)
    payload = load_checkpoint(path)
    ccfg = payload.get("cfg", {})
    cfg = ProteinClassifierConfig(
        vocab_size=28,
        n_layer=int(ccfg.get("n_layer", 4)), n_head=int(ccfg.get("n_head", 4)),
        n_embd=int(ccfg.get("n_embd", 256)), block_size=int(ccfg.get("block_size", 512)),
        dropout=0.0, pooling=str(ccfg.get("pooling", pooling)),
        **({"bidirectional": bool(ccfg.get("bidirectional", True))} if bidirectional else {}),
    )
    return load_frozen(payload, "multitask", cfg, device), cfg, payload
