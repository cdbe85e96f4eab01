"""The six-step interpretability analysis over a trained run (twin of
``genomics_lm_tpu/evals/analysis.py``): token-frequency statistics, the PCA
of the token embeddings, per-layer attention maps of a probe sequence,
next-token probe accuracy, the gradient saliency of the top next-token
prediction, and a bundled summary, each written into the run's directory
as JAX writes them (``tables/frequencies.json``, ``charts/embedding_pca.png``,
``charts/attention_layer{i}.png``, ``tables/next_token_probe.json``,
``tables/saliency.json``, ``tables/run_summary.{json,md}``).

The model runs on its own device (the card unless the caller names
another) under ``torch.no_grad``, apart from the saliency's gradient
(``dashboard.py::saliency_data``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.evals.visualizer import plot_attention_heatmap, plot_embedding_pca
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.utils.device import module_device


def analyze_frequencies(dataset, itos: list[str], out_dir: Path) -> dict:
    """Step 1: token/codon frequency statistics for a packed split."""
    counts = np.zeros(len(itos), np.int64)
    for start in range(0, len(dataset), 512):
        x, y = dataset.fetch_batch(list(range(start, min(start + 512, len(dataset)))))
        counts += np.bincount(y.reshape(-1), minlength=len(itos))
    counts[0] = 0  # PAD targets are padding, not data
    total = counts.sum()
    rows = [
        {"token": itos[i], "count": int(c), "frequency": float(c / max(total, 1))}
        for i, c in enumerate(counts)
    ]
    top = sorted(rows, key=lambda r: -r["count"])[:20]
    report = {"total_tokens": int(total), "top_tokens": top}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "frequencies.json").write_text(json.dumps({"rows": rows, **report}, indent=2))
    return report


def analyze_embeddings(model, out_dir: Path, itos: list[str]) -> dict:
    """Step 2: PCA of the token-embedding table (codon clusters)."""
    emb = model.tok_emb.weight.detach().float().cpu().numpy()
    labels = [tok[0] if len(tok) == 3 and "<" not in tok else "special" for tok in itos]
    coords = plot_embedding_pca(
        emb, labels, out_dir / "embedding_pca.png", title="Token embedding PCA"
    )
    return {"n_tokens": emb.shape[0], "pca_var_axes": coords.shape[1]}


@torch.no_grad()
def analyze_attention(model, cfg, dna: str, out_dir: Path, itos: list[str], stoi) -> dict:
    """Step 3: per-layer mean attention maps for a probe sequence."""
    from genomics_lm_torch.evals.playground import dna_to_context_ids

    ids = dna_to_context_ids(dna, stoi)
    idx = torch.tensor([ids], dtype=torch.long, device=module_device(model))
    maps = codon_gpt.attention_maps(model, cfg, idx)
    tokens = [itos[i] for i in ids]
    for layer, m in enumerate(maps):
        plot_attention_heatmap(
            m[0].cpu().numpy().mean(axis=0), out_dir / f"attention_layer{layer}.png",
            tokens=tokens, title=f"Layer {layer} mean attention",
        )
    return {"n_layers": len(maps), "tokens": tokens}


@torch.no_grad()
def probe_next_token(model, cfg, dataset, out_dir: Path, *, n_batches: int = 8,
                     batch_size: int = 32) -> dict:
    """Step 4: top-1/top-5 next-token accuracy on a held-out split."""
    device = module_device(model)

    def topk_hits(x, y):
        logits, _ = codon_gpt.forward(model, cfg, x)
        order = torch.argsort(logits, dim=-1, stable=True)  # jnp.argsort's order
        valid = y != 0
        top1 = (order[..., -1] == y) & valid
        top5 = (order[..., -5:] == y[..., None]).any(dim=-1) & valid
        return top1.sum(), top5.sum(), valid.sum()

    t1 = t5 = n = 0
    for start in range(0, min(len(dataset), n_batches * batch_size), batch_size):
        x, y = dataset.fetch_batch(
            list(range(start, min(start + batch_size, len(dataset))))
        )
        a, b, c = topk_hits(torch.from_numpy(np.asarray(x, np.int64)).to(device),
                            torch.from_numpy(np.asarray(y, np.int64)).to(device))
        t1 += int(a)
        t5 += int(b)
        n += int(c)
    report = {
        "top1_accuracy": t1 / max(n, 1),
        "top5_accuracy": t5 / max(n, 1),
        "tokens": n,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "next_token_probe.json").write_text(json.dumps(report, indent=2))
    return report


def analyze_saliency(run_dir: Path, dna: str, out_dir: Path, *,
                     device: str | torch.device | None = None) -> dict:
    """Step 5: gradient saliency of the top next-token prediction."""
    from genomics_lm_torch.dashboard import saliency_data

    payload = saliency_data(run_dir, dna, device=device)
    rows = [
        {"position": i, "token": tok, "saliency": float(s)}
        for i, (tok, s) in enumerate(zip(payload["tokens"], payload["saliency"]))
    ]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "saliency.json").write_text(json.dumps(rows, indent=2))
    top = max(rows, key=lambda r: r["saliency"]) if rows else None
    return {"positions": len(rows), "top": top}


def export_run_summary(run_dir: Path, steps: dict, out_dir: Path) -> Path:
    """Step 6: bundle all analysis outputs into one summary document."""
    from genomics_lm_torch.evals.aggregator import load_run

    run = load_run(run_dir)
    summary = {
        "run_id": run["run_id"],
        "meta": run.get("meta"),
        "analysis": steps,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "run_summary.json"
    out_path.write_text(json.dumps(summary, indent=2, default=str) + "\n")
    md = [f"# Analysis summary — {run['run_id']}", ""]
    for name, payload in steps.items():
        md.append(f"## {name}")
        md.append("```json")
        md.append(json.dumps(payload, indent=2, default=str))
        md.append("```")
        md.append("")
    (out_dir / "run_summary.md").write_text("\n".join(md))
    return out_path


def run_full_analysis(
    run_dir: str | Path,
    val_npz: str | Path,
    *,
    probe_dna: str = "ATGAAACCCGGGTTT",
    device: str | torch.device | None = None,
) -> dict:
    """Execute steps 1–6 and return the collected reports."""
    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals.playground import load_codon_model

    run_dir = Path(run_dir)
    out_dir = run_dir / "charts"
    tables_dir = run_dir / "tables"
    model, cfg, itos, stoi = load_codon_model(run_dir, device=device)
    cfg = cfg.replace(dropout=0.0)
    ds = PackedDataset(val_npz)

    steps = {}
    steps["frequencies"] = analyze_frequencies(ds, itos, tables_dir)
    steps["embeddings"] = analyze_embeddings(model, out_dir, itos)
    steps["attention"] = analyze_attention(model, cfg, probe_dna, out_dir, itos, stoi)
    steps["next_token_probe"] = probe_next_token(model, cfg, ds, tables_dir)
    steps["saliency"] = analyze_saliency(run_dir, probe_dna, tables_dir,
                                         device=module_device(model))
    export_run_summary(run_dir, steps, tables_dir)
    return steps


__all__ = ["analyze_attention", "analyze_embeddings", "analyze_frequencies",
           "analyze_saliency", "export_run_summary", "probe_next_token",
           "run_full_analysis"]
