"""Critic / EBM scoring of candidate amino-acid sequences for guidance (twin
of ``genomics_lm_tpu/protein/critic_scoring.py``).

Candidates are BOS/EOS-wrapped, padded to the longest and run through the
multi-task critic in one batch on the critic's device; classifier-head
mode returns ``log(softmax[target_class] + 1e-10)``, EBM mode the negative
energy of the bottleneck latent. ``make_score_fn`` binds them into the
numpy ``score_fn(aa_seqs)`` that ``generation/constrained.py``'s guided
generators call; ``load_score_fn`` builds it from checkpoint paths (either
package's), ``score_candidate_tasks`` reads every task for one candidate.

``load_critic`` (which ``load_score_fn`` and the generation experiments
call) builds the critic's config from the checkpoint's
``n_layer``/``n_head``/``n_embd``/``block_size``/``pooling`` and JAX's
defaults for the rest: it reads no ``bidirectional``, so a critic trained
causal is scored bidirectionally, as in JAX (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_lm_torch.models.protein import (
    ProteinClassifierConfig,
    ebm_energy,
    extract_latent,
    multitask_forward,
)


def _tokenize_batch(tokenizer, aa_seqs, device):
    ids_list = [
        [tokenizer.bos_token_id]
        + tokenizer.encode_sequence(seq)
        + [tokenizer.eos_token_id]
        for seq in aa_seqs
    ]
    max_len = max(len(t) for t in ids_list)
    ids = np.full((len(ids_list), max_len), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((len(ids_list), max_len), np.int32)
    for i, t in enumerate(ids_list):
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def batch_score_critic(
    critic,
    critic_cfg: ProteinClassifierConfig,
    tokenizer,
    aa_seqs: list[str],
    target_task: str,
    target_class_idx: int | None,
    ebm=None,
) -> np.ndarray:
    """Scores (K,): log-probs of the target class, or negative energies."""
    if not aa_seqs:
        return np.zeros(0, np.float32)
    ids, mask = _tokenize_batch(tokenizer, aa_seqs, _device(critic))
    if target_task == "ebm" and ebm is not None:
        latent = extract_latent(critic, critic_cfg, ids, mask)
        return -ebm_energy(ebm, latent).cpu().numpy()
    logits_dict = multitask_forward(critic, critic_cfg, ids, mask)
    if target_task not in logits_dict:
        return np.zeros(len(aa_seqs), np.float32)
    probs = torch.softmax(logits_dict[target_task], dim=-1)
    class_idx = target_class_idx if target_class_idx is not None else 0
    if class_idx >= probs.shape[-1]:
        class_idx = 0
    return torch.log(probs[:, class_idx] + 1e-10).cpu().numpy()


def make_score_fn(
    critic,
    critic_cfg,
    tokenizer,
    *,
    target_task: str = "stability",
    target_class_idx: int | None = None,
    ebm=None,
):
    """Bind critic state into the ``score_fn(aa_seqs)`` interface used by
    ``generation.constrained.generate_cds_critic_guided``."""

    def score_fn(aa_seqs):
        return batch_score_critic(
            critic, critic_cfg, tokenizer, aa_seqs,
            target_task, target_class_idx, ebm,
        )

    return score_fn


def load_critic(critic_ckpt, *, default_pooling: str = "mean",
                device: str | torch.device | None = None):
    """``(critic, cfg, tokenizer, payload)`` from a multi-task critic
    checkpoint (either package's), frozen on ``device`` (the card unless the
    caller names another). The config takes the checkpoint's
    ``n_layer``/``n_head``/``n_embd``/``block_size``/``pooling`` and JAX's
    defaults for the rest; ``default_pooling`` is the pooling of a
    checkpoint that names none (each JAX script picks its own)."""
    from genomics_lm_torch.protein.common import load_frozen, resolve_device
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
    from genomics_lm_torch.training.checkpoints import load_checkpoint

    device = resolve_device(device)
    payload = load_checkpoint(critic_ckpt)
    cfg_map = payload.get("cfg", {})
    tokenizer = ProteinTokenizer()
    cfg = ProteinClassifierConfig(
        vocab_size=len(tokenizer),
        n_layer=int(cfg_map.get("n_layer", 4)),
        n_head=int(cfg_map.get("n_head", 4)),
        n_embd=int(cfg_map.get("n_embd", 256)),
        block_size=int(cfg_map.get("block_size", 512)),
        dropout=0.0,
        pooling=str(cfg_map.get("pooling", default_pooling)),
    )
    return load_frozen(payload, "multitask", cfg, device), cfg, tokenizer, payload


def load_ebm(ebm_ckpt, device: torch.device):
    """An EBM checkpoint's model, frozen on ``device``."""
    from genomics_lm_torch.protein.common import load_frozen
    from genomics_lm_torch.training.checkpoints import load_checkpoint

    return load_frozen(load_checkpoint(ebm_ckpt), "ebm", None, device)


def load_score_fn(
    critic_ckpt,
    *,
    ebm_ckpt=None,
    target_task: str = "stability",
    target_class_idx: int | None = None,
    device: str | torch.device | None = None,
):
    """Build a ``score_fn`` straight from checkpoint paths (CLI glue), on
    ``device`` (the card unless the caller names another).

    Returns ``(score_fn, critic_bundle)``; the bundle carries the critic
    (``model``), its config and tokenizer, the task widths and the EBM.
    """
    critic, cfg, tokenizer, payload = load_critic(critic_ckpt, device=device)
    ebm = load_ebm(ebm_ckpt, _device(critic)) if ebm_ckpt else None
    score_fn = make_score_fn(
        critic, cfg, tokenizer,
        target_task="ebm" if ebm is not None else target_task,
        target_class_idx=target_class_idx,
        ebm=ebm,
    )
    bundle = {
        "model": critic,
        "cfg": cfg,
        "tokenizer": tokenizer,
        "task_dims": payload.get("task_dims", {}),
        "ebm": ebm,
    }
    return score_fn, bundle


@torch.no_grad()
def score_candidate_tasks(bundle: dict, aa_seq: str) -> dict:
    """Per-task critic readout for one candidate: stability probability and
    prediction, family/function top-1/top-5 ids, confidences and entropy,
    and the attention-pool weights. ``bundle`` comes from ``load_score_fn``."""
    if not aa_seq:
        return {}
    ids, mask = _tokenize_batch(bundle["tokenizer"], [aa_seq], _device(bundle["model"]))
    logits_dict = multitask_forward(bundle["model"], bundle["cfg"], ids, mask)
    task_dims = bundle.get("task_dims") or {}
    scores: dict = {}

    if "stability" in logits_dict:
        stab = torch.softmax(logits_dict["stability"][0], dim=-1).cpu().numpy()
        scores["stability_prob"] = float(stab[-1])
        scores["stability_pred"] = int(stab.argmax())

    for task in ("family", "function"):
        if task not in logits_dict:
            continue
        probs = torch.softmax(logits_dict[task][0], dim=-1).cpu().numpy()
        top = min(5, int(task_dims.get(task, probs.size)))
        order = np.argsort(probs)[::-1][:top]
        scores[f"{task}_top1"] = int(order[0])
        scores[f"{task}_top1_conf"] = float(probs[order[0]])
        scores[f"{task}_top5"] = [int(i) for i in order]
        scores[f"{task}_top5_conf"] = [float(probs[i]) for i in order]
        scores[f"{task}_entropy"] = float(
            -(probs * np.log(probs + 1e-10)).sum()
        )

    if "attention_weights" in logits_dict:
        scores["attention_weights"] = logits_dict["attention_weights"][0].cpu().numpy().tolist()
    return scores


__all__ = ["batch_score_critic", "load_critic", "load_ebm", "load_score_fn", "make_score_fn",
           "score_candidate_tasks"]
