"""Pooled embeddings of CDS sequences under a trained run (twin of
``scripts/extract_embeddings.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.extract_embeddings <run_id> --input cds.fasta \\
        --out emb.npz [--pooling mean_nonpad|mean_content|eos] [--batch_size 64] \\
        [--checkpoint best.npz] [--dataset_manifest manifest.json \\
        [--require_scientific_valid]] [--device cpu]

Inputs are FASTA, CSV (``id``/``source_id`` and ``sequence``/``dna``
columns) or one sequence per line. Writes ``{X, ids}`` as a compressed NPZ
and the sha256 provenance beside it (``<out>.provenance.json``); a
manifest binds the extraction to its frozen dataset
(``evals/provenance.py``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def read_sequences(path: Path) -> tuple[list[str], list[str]]:
    text = path.read_text()
    ids, seqs = [], []
    if text.lstrip().startswith(">"):
        current_id, parts = None, []
        for line in text.splitlines():
            if line.startswith(">"):
                if current_id is not None:
                    ids.append(current_id)
                    seqs.append("".join(parts))
                current_id, parts = line[1:].split()[0], []
            else:
                parts.append(line.strip())
        if current_id is not None:
            ids.append(current_id)
            seqs.append("".join(parts))
    elif path.suffix == ".csv":
        import csv as csv_mod

        with path.open() as f:
            for row in csv_mod.DictReader(f):
                ids.append(row.get("id") or row.get("source_id") or str(len(ids)))
                seqs.append(row.get("sequence") or row.get("dna"))
    else:
        for i, line in enumerate(text.splitlines()):
            if line.strip():
                ids.append(str(i))
                seqs.append(line.strip())
    return seqs, ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--input", required=True, help="FASTA/CSV/TXT of CDS DNA")
    ap.add_argument("--out", required=True, help="output NPZ path")
    ap.add_argument("--pooling", default="mean_nonpad",
                    choices=["mean_nonpad", "mean_content", "eos"])
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--dataset_manifest", default=None,
                    help="frozen dataset manifest to bind this extraction to")
    ap.add_argument("--require_scientific_valid", action="store_true",
                    help="fail unless the manifest is marked scientific_valid")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from genomics_lm_torch.evals.embeddings import (
        extract_embeddings,
        extraction_provenance,
        ids_from_dna,
    )
    from genomics_lm_torch.evals.playground import load_codon_model, resolve_checkpoint
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, _, _ = load_codon_model(run_dir, args.checkpoint, device=args.device)
    cfg = cfg.replace(dropout=0.0)

    seqs, seq_ids = read_sequences(Path(args.input))
    rows = np.stack([ids_from_dna(s, cfg.block_size) for s in seqs])
    X = extract_embeddings(model, cfg, rows, mode=args.pooling, batch_size=args.batch_size)
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, X=X, ids=np.asarray(seq_ids))
    prov = extraction_provenance(
        checkpoint_path=resolve_checkpoint(run_dir, args.checkpoint),
        itos_path=run_dir / "itos.txt" if (run_dir / "itos.txt").exists() else None,
        pooling=args.pooling,
        n_sequences=len(seqs),
    )
    # forward_hidden is held to the JAX function's states (the port's tests),
    # so extractions made through it carry the causal_verified status
    prov["validation_status"] = "causal_verified"
    if args.dataset_manifest or args.require_scientific_valid:
        from genomics_lm_torch.evals.provenance import (
            EvaluationProvenanceError,
            bind_checkpoint_dataset,
            bind_dataset_manifest,
        )
        from genomics_lm_torch.training.checkpoints import load_checkpoint_meta

        if not args.dataset_manifest:
            raise EvaluationProvenanceError(
                "--require_scientific_valid needs --dataset_manifest"
            )
        _, manifest_prov = bind_dataset_manifest(
            args.dataset_manifest,
            require_scientific=args.require_scientific_valid,
        )
        # metadata-only read: the weights were already loaded above
        ckpt_cfg = dict(
            load_checkpoint_meta(resolve_checkpoint(run_dir, args.checkpoint)).get("cfg", {})
        )
        prov["dataset_manifest"] = manifest_prov
        prov["checkpoint_dataset"] = bind_checkpoint_dataset(ckpt_cfg, manifest_prov)
    out_path.with_suffix(".provenance.json").write_text(json.dumps(prov, indent=2) + "\n")
    print(f"[extract] wrote {X.shape} embeddings → {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
