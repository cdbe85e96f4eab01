"""In-silico motif perturbation: does appending a terminator-like hairpin
raise the model's stop-codon probability? (twin of
``scripts/test_perturbation_motifs.py``, the same flags plus ``--device``;
the module drops the script's ``test_`` prefix so that pytest never collects
it).

    python -m genomics_lm_torch.evals.perturbation_motifs <run_id> --npz val.npz \\
        [--n_prefixes 16] [--prefix_codons 12] [--seed 0] [--out report.json] [--device cpu]

Up to ``--n_prefixes`` packed rows of ``--npz``, drawn with ``--seed``, give
prefixes of ``--prefix_codons`` codons (a row with fewer is skipped). For
each, the next-token stop-codon mass after the prefix alone, after the
prefix plus ``termination_motifs.synthetic_hairpin()`` as codons, and after
the prefix plus a shuffle of the hairpin (the control, shuffled by the same
generator), from the run's cached decoder (the card unless ``--device``
names another). Reports the mean masses, the hairpin's uplift and its
specificity against the shuffle; writes
``<run>/scores/perturbation_motifs.json`` (or ``--out``) and prints it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_id")
    ap.add_argument("--n_prefixes", type=int, default=16)
    ap.add_argument("--prefix_codons", type=int, default=12)
    ap.add_argument("--npz", required=True, help="held-out split for prefixes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals.playground import make_decoder
    from genomics_lm_torch.evals.termination_motifs import synthetic_hairpin
    from genomics_lm_torch.generation.constrained import stop_token_ids
    from genomics_lm_torch.tokenizers.codon import stoi as codon_stoi
    from genomics_lm_torch.utils.cli import resolve_run_dir

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    decoder, itos, stoi = make_decoder(run_dir, device=args.device)
    stop_ids = stop_token_ids(stoi)
    rng = np.random.default_rng(args.seed)

    ds = PackedDataset(args.npz)
    rows = rng.choice(len(ds), min(args.n_prefixes, len(ds)), replace=False)
    x, _ = ds.fetch_batch(rows)

    def stop_mass(ids: list[int]) -> float:
        logits = np.asarray(decoder.next_logits(list(ids)), np.float64)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        return float(sum(probs[s] for s in stop_ids))

    def codonize(dna: str) -> list[int]:
        dna = dna[: 3 * (len(dna) // 3)]
        return [codon_stoi[dna[i : i + 3]] for i in range(0, len(dna), 3)
                if dna[i : i + 3] in codon_stoi]

    motif = synthetic_hairpin()
    results = {"baseline": [], "hairpin_motif": [], "shuffled_control": []}
    for row in x:
        prefix, codons = [], 0
        for t in row:
            t = int(t)
            if t == 0:
                break
            prefix.append(t)
            if len(itos[t]) == 3 and "<" not in itos[t]:
                codons += 1
            if codons >= args.prefix_codons:
                break
        if codons < args.prefix_codons:
            continue
        results["baseline"].append(stop_mass(prefix))
        results["hairpin_motif"].append(stop_mass(prefix + codonize(motif)))
        shuffled = list(motif)
        rng.shuffle(shuffled)
        results["shuffled_control"].append(stop_mass(prefix + codonize("".join(shuffled))))

    report = {
        "n_prefixes": len(results["baseline"]),
        "motif": motif,
        "mean_stop_mass": {k: float(np.mean(v)) if v else None for k, v in results.items()},
    }
    if results["baseline"]:
        report["hairpin_uplift"] = (report["mean_stop_mass"]["hairpin_motif"]
                                    - report["mean_stop_mass"]["baseline"])
        report["specificity_vs_shuffle"] = (report["mean_stop_mass"]["hairpin_motif"]
                                            - report["mean_stop_mass"]["shuffled_control"])
    out = Path(args.out) if args.out else run_dir / "scores" / "perturbation_motifs.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report, indent=2))
    return 0


__all__ = ["main", "parser"]


if __name__ == "__main__":
    raise SystemExit(main())
