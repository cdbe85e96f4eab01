"""Dashboard data layer: the page functions, testable without a UI (twin of
``genomics_lm_tpu/dashboard.py``).

Each function returns the payload one page of ``web_dashboard.py`` renders:
the run browser and one run's details (files only), the playground's
next-codon distribution and constrained generation (``CachedDecoder``: the
decode kernel on the card), attention maps, pooled embeddings with their
2-D PCA, the gradient saliency of the top next-token prediction (the flash
forward, dQ and dK/dV kernels on the card under ``attention_impl="flash"``)
and the DNAshape profiles. A model page loads the run on ``device`` (the
card unless the caller names another, as every entry point of the port).

The embeddings' PCA is ``evals/visualizer.py::pca_2d``: sklearn ``PCA``'s
coordinates (its centring and sign rule) without sklearn.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.evals.aggregator import load_all_runs, load_run, summary_rows


def run_browser_data(runs_root: str | Path = "runs") -> dict:
    """Run table + per-run summary for the browser page."""
    runs = load_all_runs(runs_root)
    return {"runs": runs, "table": summary_rows(runs)}


def run_details_data(run_dir: str | Path) -> dict:
    """Curves, meta, checkpoints, and artifacts for one run."""
    run = load_run(run_dir)
    curves = run.get("curves") or []
    series = {}
    if curves:
        for key in curves[0]:
            try:
                series[key] = [float(r[key]) for r in curves]
            except (TypeError, ValueError):
                continue
    return {"run": run, "series": series}


def playground_next_codon(run_dir: str | Path, dna: str, top_k: int = 10, *,
                          device: str | torch.device | None = None) -> dict:
    """Next-codon distribution for the playground tab."""
    from genomics_lm_torch.evals.playground import (
        dna_to_context_ids,
        make_decoder,
        query_next_codon,
    )

    decoder, itos, stoi = make_decoder(run_dir, device=device)
    ids = dna_to_context_ids(dna, stoi)
    return {
        "prompt": dna,
        "context_tokens": [itos[i] for i in ids],
        "next": query_next_codon(decoder, ids, itos, top_k=top_k),
    }


def playground_generate(run_dir: str | Path, dna: str, *, target_codons: int = 16,
                        hard_cap: int = 48, seed: int = 0,
                        device: str | torch.device | None = None) -> dict:
    """Constrained generation (with ReD log) for the playground tab."""
    from genomics_lm_torch.evals.playground import dna_to_context_ids, make_decoder
    from genomics_lm_torch.generation import constrained as gen

    decoder, itos, stoi = make_decoder(run_dir, device=device)
    ids = dna_to_context_ids(dna, stoi)
    out_ids, info = gen.generate_cds_red(
        decoder, ids, stoi, itos, target_codons=target_codons,
        hard_cap=hard_cap, rng=np.random.default_rng(seed),
    )
    dna_out = "".join(itos[t] for t in out_ids if len(itos[t]) == 3 and "<" not in itos[t])
    return {"dna": dna_out, "ids": out_ids, "info": info}


def _load(run_dir, device):
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.utils.device import module_device

    model, cfg, itos, stoi = load_codon_model(run_dir, device=device)
    return model, cfg.replace(dropout=0.0), itos, stoi, module_device(model)


def attention_data(run_dir: str | Path, dna: str, layer: int = -1, *,
                   device: str | torch.device | None = None) -> dict:
    """Per-head attention maps for a prompt (attention tab)."""
    from genomics_lm_torch.evals.playground import dna_to_context_ids
    from genomics_lm_torch.models.codon_gpt import attention_maps

    model, cfg, itos, stoi, dev = _load(run_dir, device)
    ids = dna_to_context_ids(dna, stoi)
    with torch.no_grad():
        maps = attention_maps(model, cfg, torch.tensor([ids], dtype=torch.long, device=dev))
    return {
        "tokens": [itos[i] for i in ids],
        "n_layers": len(maps),
        "attention": maps[layer][0].float().cpu().numpy(),  # (H, T, T)
    }


def embeddings_data(run_dir: str | Path, sequences: list[str], *,
                    device: str | torch.device | None = None) -> dict:
    """Pooled embeddings + 2-D PCA coordinates (embeddings tab)."""
    from genomics_lm_torch.evals.embeddings import extract_embeddings, ids_from_dna
    from genomics_lm_torch.evals.visualizer import pca_2d

    model, cfg, _, _, _ = _load(run_dir, device)
    rows = np.stack([ids_from_dna(s, cfg.block_size) for s in sequences])
    X = extract_embeddings(model, cfg, rows)
    coords = pca_2d(X) if len(sequences) >= 2 else None
    return {"embeddings": X, "pca": coords}


def input_saliency(model, cfg, idx: torch.Tensor) -> np.ndarray:
    """The gradient norm, per context position of the (1, T) prompt ``idx``,
    of the last position's top logit with respect to the input embeddings.

    The embeddings are the float32 table rows (plus positions), as JAX's
    ``saliency_data`` takes them, and run through the inference blocks
    (``_block_apply`` without dropout; a MoE block routes dropless),
    ``ln_f`` and the LM head. Under ``attention_impl="flash"`` on the card
    the gradient runs the flash forward, dQ and dK/dV kernels once a layer.
    """
    from genomics_lm_torch.models.codon_gpt import (
        _block_apply,
        _layer_norm,
        _lm_logits,
        _rope_for,
    )
    from genomics_lm_torch.ops.masks import segment_ids_from_tokens

    seg = segment_ids_from_tokens(idx, cfg.sep_id) if cfg.sep_id is not None else None
    with torch.enable_grad():
        emb = model.tok_emb.weight.detach()[idx]
        if not cfg.use_rope:
            emb = emb + model.pos_emb.weight.detach()[: idx.shape[1]][None]
        emb.requires_grad_(True)
        rope = _rope_for(cfg, idx)
        h = emb
        for block in model.blocks:
            h, _ = _block_apply(block, cfg, h, segment_ids=seg, attention_window=None,
                                rope=rope, drop=False, generator=None)
        last = _lm_logits(model, cfg, _layer_norm(model.ln_f, h))[0, -1]
        (grad,) = torch.autograd.grad(last[torch.argmax(last)], emb)
    return grad[0].norm(dim=-1).float().cpu().numpy()


def saliency_data(run_dir: str | Path, dna: str, *,
                  device: str | torch.device | None = None) -> dict:
    """Input-embedding gradient saliency per context position (saliency tab)."""
    from genomics_lm_torch.evals.playground import dna_to_context_ids

    model, cfg, itos, stoi, dev = _load(run_dir, device)
    ids = dna_to_context_ids(dna, stoi)
    idx = torch.tensor([ids], dtype=torch.long, device=dev)
    return {"tokens": [itos[i] for i in ids], "saliency": input_saliency(model, cfg, idx)}


def shape_profile_data(dna: str) -> dict:
    """Per-base heuristic DNAshape profile for the playground tab (minor
    groove width, roll, electrostatic potential from pentamer heuristics)."""
    from genomics_lm_torch.models.biophysics import get_theoretical_shape

    seq = dna.strip().upper()
    profile = get_theoretical_shape(seq)
    return {
        "positions": list(range(len(seq))),
        "bases": list(seq),
        **profile,
    }


def shape_comparison_data(wild_type: str, variant: str) -> dict:
    """Aligned WT-vs-variant DNAshape profiles (synonymous-shift explorer):
    per-parameter paired series plus the mean absolute per-base deltas."""
    wt = shape_profile_data(wild_type)
    var = shape_profile_data(variant)
    n = min(len(wt["bases"]), len(var["bases"]))
    deltas = {}
    for param in ("MGW", "Roll", "EP"):
        a = np.asarray(wt[param][:n])
        b = np.asarray(var[param][:n])
        deltas[f"mean_abs_delta_{param}"] = float(np.abs(a - b).mean()) if n else 0.0

    def gc(s: str) -> float:
        return (s.count("G") + s.count("C")) / len(s) if s else 0.0

    return {
        "wild_type": wt,
        "variant": var,
        "aligned_length": n,
        "gc_wild_type": gc("".join(wt["bases"])),
        "gc_variant": gc("".join(var["bases"])),
        **deltas,
    }


__all__ = [
    "attention_data",
    "embeddings_data",
    "input_saliency",
    "playground_generate",
    "playground_next_codon",
    "run_browser_data",
    "run_details_data",
    "saliency_data",
    "shape_comparison_data",
    "shape_profile_data",
]
