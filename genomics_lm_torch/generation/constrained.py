"""Constrained CDS generation: masking, termination bias, ReD, guidance.

Twin of ``genomics_lm_tpu/generation/constrained.py`` over the port's
``generation/decode.py::CachedDecoder``; the loops are host-side numpy and
copy JAX's line for line, so the ``info`` dicts keep JAX's schema key for
key and, from the same ``np.random.Generator`` and the same logits, the
same tokens come out (the draws go through ``decode.sample_token`` and
``Generator.choice`` as in JAX).

- ``generate_model_raw``         — unconstrained, stop on a biological stop or EOS
- ``generate_cds_constrained``   — CDS-token masking, target/hard-cap budgets,
  ``require_terminal_stop``, the termination head's stop bias, the
  multi-offset prior's logit blending
- ``generate_cds_red``           — Reset-and-Discard retries
- ``batch_red_sampler``          — multi-prefix ReD under a global token budget
- ``generate_cds_critic_guided`` — top-K critic/EBM log-prob blending per step
- ``generate_cds_synonymous``    — codons constrained to translate exactly to a
  target protein, forced stop + EOS

Each step's logits come from ``CachedDecoder.next_logits`` (the prefill,
then one decode step, through the decode kernel on the card); the
multi-offset prior takes the uncached ``next_token_logits`` each step, as
JAX does, because it indexes the offset heads' per-position outputs (the
flash forward at batch 1 on the card). Critic scoring is a numpy callable
``score_fn(aa_seqs) → np.ndarray``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from genomics_lm_torch.generation.decode import (
    CachedDecoder,
    next_token_logits,
    sample_token,
)
from genomics_lm_torch.generation.genetic_code import AA_TO_CODONS, translate_codons_to_aa

STOP_CODONS = {"TAA", "TAG", "TGA"}
NEG_INF = float("-inf")


def stop_token_ids(stoi: Dict[str, int]) -> List[int]:
    return [stoi[c] for c in sorted(STOP_CODONS) if c in stoi]


def cds_token_ids(itos: List[str]) -> List[int]:
    return [i for i, tok in enumerate(itos) if len(tok) == 3 and set(tok) <= set("ACGT")]


def mask_to_allowed_tokens(logits: np.ndarray, allowed_ids: List[int]) -> np.ndarray:
    if not allowed_ids:
        return logits
    masked = np.full_like(logits, NEG_INF)
    masked[np.asarray(allowed_ids)] = logits[np.asarray(allowed_ids)]
    return masked


def _is_codon(tok: str) -> bool:
    return len(tok) == 3 and set(tok) <= set("ACGT")


def generate_model_raw(
    decoder: CachedDecoder,
    ctx_ids: List[int],
    stoi: Dict[str, int],
    itos: List[str],
    max_new_tokens: int,
    temperature: float = 1.0,
    topk: int = 0,
    rng: np.random.Generator | None = None,
) -> Tuple[List[int], Dict[str, object]]:
    """Sample the raw vocabulary; stop on biological stop or EOS."""
    rng = rng or np.random.default_rng()
    ids = list(ctx_ids)
    eos_idx = stoi.get("<EOS_CDS>")
    had_terminal_stop = False
    generated_codons = 0
    stop_reason = "max_new_tokens"

    for _ in range(int(max_new_tokens)):
        logits = decoder.next_logits(ids)
        next_id = sample_token(logits, temperature, topk, rng)
        ids.append(next_id)
        tok = itos[next_id] if 0 <= next_id < len(itos) else ""
        if _is_codon(tok):
            generated_codons += 1
            if tok in STOP_CODONS:
                had_terminal_stop = True
                stop_reason = "biological_stop"
                break
        if eos_idx is not None and next_id == eos_idx:
            stop_reason = "eos"
            break

    return ids, {
        "protocol": "raw_model",
        "cds_only": False,
        "require_terminal_stop": False,
        "guidance_components": [],
        "had_terminal_stop": had_terminal_stop,
        "early_stop": False,
        "hit_hard_cap": stop_reason == "max_new_tokens",
        "generated_codons": generated_codons,
        "generated_tokens": len(ids) - len(ctx_ids),
        "max_new_tokens": int(max_new_tokens),
        "stop_reason": stop_reason,
    }


def _apply_termination_stop_bias(logits, aux, stop_ids, stop_bias, trigger_class_max):
    if stop_bias <= 0.0 or not stop_ids:
        return logits, None
    term_logits = aux.get("termination_logits")
    if term_logits is None:
        return logits, None
    pred_class = int(np.argmax(term_logits))
    if pred_class <= int(trigger_class_max):
        logits = logits.copy()
        logits[np.asarray(stop_ids)] += float(stop_bias)
    return logits, pred_class


def _apply_multi_offset_priors(logits, aux, ctx_len, offsets, weights):
    """Blend offset-head priors predicted ``offset`` steps ago."""
    modified = logits.copy()
    any_found = False
    for offset in offsets:
        weight = weights.get(offset, 0.0)
        if weight == 0.0:
            continue
        prior_seq = aux.get(f"offset_{offset}_logits")
        if prior_seq is None:
            continue
        idx = ctx_len - offset
        if idx >= 0 and prior_seq.ndim == 2 and idx < prior_seq.shape[0]:
            modified += float(weight) * prior_seq[idx]
            any_found = True
    return modified if any_found else logits


def generate_cds_constrained(
    decoder: CachedDecoder,
    ctx_ids: List[int],
    stoi: Dict[str, int],
    itos: List[str],
    target_codons: int,
    hard_cap: int,
    require_terminal_stop: bool = False,
    temperature: float = 1.0,
    topk: int = 0,
    termination_bias_enabled: bool = False,
    termination_stop_bias: float = 0.0,
    termination_trigger_class_max: int = 0,
    termination_bias_window: int = 0,
    cds_only: bool = True,
    multi_offset_prior_enabled: bool = False,
    multi_offset_prior_weights: Dict[int, float] | None = None,
    rng: np.random.Generator | None = None,
) -> Tuple[List[int], Dict[str, object]]:
    """Generate codons under length/termination constraints."""
    rng = rng or np.random.default_rng()
    ids = list(ctx_ids)
    had_terminal_stop = False
    early_stop = False
    hit_hard_cap = False
    new_codons = 0
    eos_idx = stoi.get("<EOS_CDS>")
    stop_ids = stop_token_ids(stoi)
    allowed_cds_ids = cds_token_ids(itos) if cds_only else []
    termination_bias_steps = 0
    last_termination_class = None

    total_new_tokens = 0
    while new_codons < int(hard_cap) and total_new_tokens < 3 * int(hard_cap):
        total_new_tokens += 1
        bias_length_ok = new_codons >= max(
            0, int(target_codons) - int(termination_bias_window)
        )
        need_aux = (
            termination_bias_enabled and bias_length_ok
        ) or multi_offset_prior_enabled
        if need_aux:
            # offset priors index into the full per-position head outputs,
            # so take the uncached path that returns them
            if multi_offset_prior_enabled:
                logits, aux = next_token_logits(
                    decoder.model, decoder.cfg, ids, return_aux=True
                )
            else:
                logits, aux = decoder.next_logits(ids, return_aux=True)
        else:
            logits = decoder.next_logits(ids)
            aux = {}

        if multi_offset_prior_enabled and aux and multi_offset_prior_weights:
            ctx_len = min(len(ids), decoder.cfg.block_size)
            logits = _apply_multi_offset_priors(
                logits, aux,
                ctx_len=ctx_len,
                offsets=list(multi_offset_prior_weights.keys()),
                weights=multi_offset_prior_weights,
            )

        if termination_bias_enabled and bias_length_ok and aux:
            logits, term_class = _apply_termination_stop_bias(
                logits, aux,
                stop_ids=stop_ids,
                stop_bias=float(termination_stop_bias),
                trigger_class_max=int(termination_trigger_class_max),
            )
            if term_class is not None:
                last_termination_class = term_class
                if term_class <= int(termination_trigger_class_max) and float(
                    termination_stop_bias
                ) > 0:
                    termination_bias_steps += 1

        if cds_only:
            logits = mask_to_allowed_tokens(logits, allowed_cds_ids)
        next_id = sample_token(logits, temperature, topk, rng)
        ids.append(int(next_id))

        tok = itos[next_id] if 0 <= next_id < len(itos) else ""
        if _is_codon(tok):
            new_codons += 1
            if tok in STOP_CODONS:
                if new_codons < int(target_codons):
                    early_stop = True
                    if not require_terminal_stop:
                        had_terminal_stop = True
                        break
                else:
                    had_terminal_stop = True
                    break

        if eos_idx is not None and next_id == eos_idx:
            if new_codons >= int(target_codons) or not require_terminal_stop:
                break

        if new_codons >= int(target_codons) and not require_terminal_stop:
            break

    if new_codons >= int(hard_cap):
        hit_hard_cap = True

    guidance_components = []
    if termination_bias_enabled:
        guidance_components.append("termination_bias")
    if multi_offset_prior_enabled:
        guidance_components.append("multi_offset_prior")
    if require_terminal_stop:
        guidance_components.append("forced_terminal_stop")
    if not cds_only:
        guidance_components.append("non_cds_tokens")
    info = {
        "protocol": "guided" if guidance_components else "cds_constrained",
        "guidance_components": guidance_components,
        "had_terminal_stop": bool(had_terminal_stop),
        "early_stop": bool(early_stop),
        "hit_hard_cap": bool(hit_hard_cap),
        "target_codons": int(target_codons),
        "generated_codons": int(new_codons),
        "termination_bias_enabled": bool(termination_bias_enabled),
        "termination_bias_steps": int(termination_bias_steps),
        "termination_bias_window": int(termination_bias_window),
        "last_termination_class": last_termination_class,
        "cds_only": bool(cds_only),
        "require_terminal_stop": bool(require_terminal_stop),
        "generated_tokens": int(total_new_tokens),
    }
    return ids, info


def generate_cds_red(
    decoder: CachedDecoder,
    ctx_ids: List[int],
    stoi: Dict[str, int],
    itos: List[str],
    target_codons: int,
    hard_cap: int,
    max_attempts: int = 5,
    rng: np.random.Generator | None = None,
    **constrained_kwargs,
) -> Tuple[List[int], Dict[str, object]]:
    """Reset-and-Discard for one prefix: retry until terminal stop."""
    rng = rng or np.random.default_rng()
    total_tokens = 0
    last_ids: List[int] = []
    last_info: Dict[str, object] = {}
    for attempt in range(max_attempts):
        ids, info = generate_cds_constrained(
            decoder, ctx_ids, stoi, itos, target_codons, hard_cap,
            require_terminal_stop=True, rng=rng, **constrained_kwargs,
        )
        total_tokens += info["generated_codons"]
        last_ids, last_info = ids, info
        if info["had_terminal_stop"]:
            last_info["attempts"] = attempt + 1
            last_info["total_tokens_red"] = total_tokens
            return ids, last_info
    last_info["attempts"] = max_attempts
    last_info["total_tokens_red"] = total_tokens
    return last_ids, last_info


def batch_red_sampler(
    decoder: CachedDecoder,
    contexts: List[List[int]],
    stoi: Dict[str, int],
    itos: List[str],
    target_codons: int,
    hard_cap: int,
    global_token_budget: int,
    rng: np.random.Generator | None = None,
    **constrained_kwargs,
) -> Tuple[Dict[int, Tuple[List[int], Dict]], List[int], int]:
    """Round-based multi-prefix ReD under a global budget."""
    rng = rng or np.random.default_rng()
    active = [(list(ctx), i) for i, ctx in enumerate(contexts)]
    solved: Dict[int, Tuple[List[int], Dict]] = {}
    total_tokens = 0
    round_idx = 0
    while active and total_tokens < global_token_budget:
        round_idx += 1
        next_active = []
        for ctx, idx in active:
            if total_tokens >= global_token_budget:
                next_active.append((ctx, idx))
                continue
            gen_ids, info = generate_cds_constrained(
                decoder, ctx, stoi, itos, target_codons, hard_cap,
                require_terminal_stop=True, rng=rng, **constrained_kwargs,
            )
            total_tokens += info["generated_codons"]
            if info["had_terminal_stop"]:
                info["round"] = round_idx
                solved[idx] = (gen_ids, info)
            else:
                next_active.append((ctx, idx))
        active = next_active
    remaining = [idx for _, idx in active]
    return solved, remaining, total_tokens


ScoreFn = Callable[[List[str]], np.ndarray]


def generate_cds_critic_guided(
    decoder: CachedDecoder,
    score_fn: ScoreFn,
    ctx_ids: List[int],
    stoi: Dict[str, int],
    itos: List[str],
    target_codons: int,
    hard_cap: int,
    alpha: float = 0.5,
    guide_top_k: int = 5,
    temperature: float = 1.0,
    cds_only: bool = True,
    require_terminal_stop: bool = False,
    ebm_guided: bool = False,
    rng: np.random.Generator | None = None,
) -> Tuple[List[int], Dict[str, object]]:
    """Top-K critic/EBM log-prob blending per generated codon.

    ``score_fn`` maps candidate AA sequences to per-candidate log-prob /
    negative-energy scores (the JAX package's
    ``protein.critic_scoring.batch_score_critic``; the protein stack is not
    ported).
    """
    rng = rng or np.random.default_rng()
    ids = list(ctx_ids)
    had_terminal_stop = False
    early_stop = False
    hit_hard_cap = False
    new_codons = 0
    eos_idx = stoi.get("<EOS_CDS>")
    allowed_cds_ids = cds_token_ids(itos) if cds_only else []

    total_new_tokens = 0
    while new_codons < int(hard_cap) and total_new_tokens < 3 * int(hard_cap):
        total_new_tokens += 1
        logits = decoder.next_logits(ids)
        if cds_only:
            logits = mask_to_allowed_tokens(logits, allowed_cds_ids)
        if temperature != 1.0:
            logits = logits / max(1e-6, float(temperature))
        shifted = logits - np.nanmax(logits[np.isfinite(logits)])
        probs = np.exp(shifted)
        probs[~np.isfinite(logits)] = 0.0
        probs = probs / probs.sum()

        k_val = min(int(guide_top_k), probs.size)
        top_idxs = np.argsort(probs)[-k_val:][::-1]
        top_vals = probs[top_idxs]

        aa_seqs, candidate_ids = [], []
        for c_id in top_idxs:
            cand_ids = ids + [int(c_id)]
            cand_codons = [
                itos[i] for i in cand_ids
                if len(itos[i]) == 3 and not (itos[i].startswith("<") or itos[i].endswith(">"))
            ]
            aa_seqs.append(translate_codons_to_aa(cand_codons))
            candidate_ids.append(int(c_id))

        critic_scores = np.asarray(score_fn(aa_seqs), dtype=np.float64)
        gen_log_probs = np.log(top_vals + 1e-10)
        blended = gen_log_probs + float(alpha) * critic_scores
        blended = blended - blended.max()
        blended_probs = np.exp(blended)
        blended_probs /= blended_probs.sum()
        next_id = candidate_ids[int(rng.choice(len(candidate_ids), p=blended_probs))]
        ids.append(next_id)

        tok = itos[next_id] if 0 <= next_id < len(itos) else ""
        if _is_codon(tok):
            new_codons += 1
            if tok in STOP_CODONS:
                if new_codons < int(target_codons):
                    early_stop = True
                    if not require_terminal_stop:
                        had_terminal_stop = True
                        break
                else:
                    had_terminal_stop = True
                    break
        if eos_idx is not None and next_id == eos_idx:
            if new_codons >= int(target_codons) or not require_terminal_stop:
                break
        if new_codons >= int(target_codons) and not require_terminal_stop:
            break

    if new_codons >= int(hard_cap):
        hit_hard_cap = True

    guidance_components = ["ebm" if ebm_guided else "critic"]
    if require_terminal_stop:
        guidance_components.append("forced_terminal_stop")
    if not cds_only:
        guidance_components.append("non_cds_tokens")
    info = {
        "protocol": "guided",
        "guidance_components": guidance_components,
        "had_terminal_stop": bool(had_terminal_stop),
        "early_stop": bool(early_stop),
        "hit_hard_cap": bool(hit_hard_cap),
        "target_codons": int(target_codons),
        "generated_codons": int(new_codons),
        "cds_only": bool(cds_only),
        "require_terminal_stop": bool(require_terminal_stop),
        "generated_tokens": int(total_new_tokens),
    }
    return ids, info


def generate_cds_synonymous(
    decoder: CachedDecoder,
    ctx_ids: List[int],
    stoi: Dict[str, int],
    itos: List[str],
    target_protein: str,
    score_fn: ScoreFn | None = None,
    alpha: float = 0.5,
    guide_top_k: int = 5,
    temperature: float = 1.0,
    ebm_guided: bool = False,
    rng: np.random.Generator | None = None,
) -> Tuple[List[int], dict]:
    """Codon generation translating exactly to ``target_protein``."""
    rng = rng or np.random.default_rng()
    ids = list(ctx_ids)
    new_codons = 0
    eos_idx = stoi.get("<EOS_CDS>")

    for target_aa in target_protein:
        logits = decoder.next_logits(ids)
        allowed_codons = AA_TO_CODONS.get(target_aa.upper(), [])
        allowed_ids = [stoi[c] for c in allowed_codons if c in stoi]
        if not allowed_ids:
            allowed_ids = cds_token_ids(itos)
        logits = mask_to_allowed_tokens(logits, allowed_ids)
        if temperature != 1.0:
            logits = logits / max(1e-6, float(temperature))
        shifted = logits - np.nanmax(logits[np.isfinite(logits)])
        probs = np.exp(shifted)
        probs[~np.isfinite(logits)] = 0.0
        probs /= probs.sum()

        if score_fn is not None and alpha != 0.0:
            valid_idxs = np.flatnonzero(probs > 0.0)
            k_val = min(int(guide_top_k), valid_idxs.size)
            if k_val > 0:
                sub = np.argsort(probs[valid_idxs])[-k_val:][::-1]
                top_idxs = valid_idxs[sub]
                top_vals = probs[top_idxs]
                aa_seqs, candidate_ids = [], []
                for c_id in top_idxs:
                    cand_ids = ids + [int(c_id)]
                    cand_codons = [
                        itos[i] for i in cand_ids
                        if len(itos[i]) == 3
                        and not (itos[i].startswith("<") or itos[i].endswith(">"))
                    ]
                    aa_seqs.append(translate_codons_to_aa(cand_codons))
                    candidate_ids.append(int(c_id))
                critic_scores = np.asarray(score_fn(aa_seqs), dtype=np.float64)
                blended = np.log(top_vals + 1e-10) + float(alpha) * critic_scores
                blended -= blended.max()
                bp = np.exp(blended)
                bp /= bp.sum()
                next_id = candidate_ids[int(rng.choice(len(candidate_ids), p=bp))]
            else:
                next_id = int(rng.choice(probs.size, p=probs))
        else:
            next_id = int(rng.choice(probs.size, p=probs))
        ids.append(next_id)
        new_codons += 1

    # forced terminal stop codon
    logits = decoder.next_logits(ids)
    stop_codons = AA_TO_CODONS.get("_", ["TAA", "TAG", "TGA"])
    stop_ids = [stoi[c] for c in stop_codons if c in stoi]
    logits = mask_to_allowed_tokens(logits, stop_ids)
    shifted = logits - np.nanmax(logits[np.isfinite(logits)])
    probs = np.exp(shifted)
    probs[~np.isfinite(logits)] = 0.0
    probs /= probs.sum()
    ids.append(int(rng.choice(probs.size, p=probs)))
    new_codons += 1
    if eos_idx is not None:
        ids.append(eos_idx)

    info = {
        "protocol": "guided",
        "guidance_components": [
            "synonymous_template",
            *(["ebm" if ebm_guided else "critic"] if score_fn is not None else []),
        ],
        "had_terminal_stop": True,
        "early_stop": False,
        "hit_hard_cap": False,
        "target_codons": len(target_protein) + 1,
        "generated_codons": new_codons,
        "cds_only": True,
        "require_terminal_stop": True,
        "generated_tokens": len(ids) - len(ctx_ids),
    }
    return ids, info


__all__ = [
    "STOP_CODONS",
    "batch_red_sampler",
    "cds_token_ids",
    "generate_cds_constrained",
    "generate_cds_critic_guided",
    "generate_cds_red",
    "generate_cds_synonymous",
    "generate_model_raw",
    "mask_to_allowed_tokens",
    "stop_token_ids",
]
