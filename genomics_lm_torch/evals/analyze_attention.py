"""Per-layer attention maps of a probe sequence under a trained run (twin
of ``scripts/analyze_attention.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.analyze_attention <run_id> [--dna ATGAAACCCGGGTTT] \\
        [--run_root runs] [--device cpu]

Writes ``<run>/charts/attention_layer{i}.png`` (each layer's map averaged
over heads) and prints the report: the number of layers and the probe's
tokens.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--dna", default="ATGAAACCCGGGTTT")
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from genomics_lm_torch.evals.analysis import analyze_attention
    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    model, cfg, itos, stoi = load_codon_model(run_dir, device=args.device)
    cfg = cfg.replace(dropout=0.0)
    report = analyze_attention(model, cfg, args.dna, run_dir / "charts", itos, stoi)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
