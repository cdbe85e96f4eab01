"""Prefix-generation benchmark for the codon LM (twin of
``scripts/eval_generation_prefix.py``, the same flags plus ``--device``).

    python -m genomics_lm_torch.evals.eval_generation_prefix <run_id> --npz val_bs512.npz \
        [--train_npz train_bs512.npz] [--preset quick|standard|full] [--k_list 1,3,5,10] \
        [--nll_controls] [--emit_replay replay.jsonl] [--termination_bias ...] \
        [--multi_offset_prior ...] [--target_protein MKV...] [--device cpu]

Real CDS prefixes of a frozen split are continued under every active
protocol (``raw_model`` and ``cds_constrained`` always, ``guided`` when any
guidance is on: termination bias, the multi-offset prior, a synonymous
template from ``--target_protein``, a forced terminal stop, non-CDS tokens),
from paired sha256 seeds; each sample is scored by ``evals/gen_prefix.py``
(the decode kernel on the card generates, the flash forward scores), with
the NLL-vs-controls and memorization audits on request. Outputs:
samples.csv, protocol_samples.csv, protocol_summary.csv (bootstrap CIs),
summary.csv, generated_protocols.fasta, protocol_manifest.json, the four
metric-vs-k plots (skipped with a line without matplotlib) and the replay
JSONL. ``--critic_guidance``, ``--ebm_guidance``, ``--critic_ckpt`` and
``--ebm_ckpt`` raise ``NotImplementedError``: the critic belongs to the
protein stack, which is not ported (``--critic_stability`` without a critic
checkpoint does nothing, as in JAX).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_id")
    ap.add_argument("--npz", required=True, help="frozen split for prefixes")
    ap.add_argument("--train_npz", default=None,
                    help="training split for usage/memorization audits")
    ap.add_argument("--dataset_manifest", default=None,
                    help="frozen manifest to bind the source split to")
    ap.add_argument("--preset", choices=sorted(("quick", "standard", "full")),
                    default="quick")
    ap.add_argument("--k_list", default="1,3,5,10")
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--max_genes", type=int, default=None)
    ap.add_argument("--max_new", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--ci_resamples", type=int, default=1000)
    ap.add_argument("--out_label", default="gen_prefix")
    ap.add_argument("--progress_every", type=int, default=20)
    # long-protein controls
    ap.add_argument("--min_aa_len", type=int, default=8)
    ap.add_argument("--target_aa_len", type=int, default=64)
    ap.add_argument("--max_aa_len", type=int, default=400)
    ap.add_argument("--special_margin", type=int, default=6)
    ap.add_argument("--require_terminal_stop", action="store_true")
    # guidance
    ap.add_argument("--termination_bias", action="store_true")
    ap.add_argument("--termination_stop_bias", type=float, default=0.0)
    ap.add_argument("--termination_trigger_class_max", type=int, default=0)
    ap.add_argument("--termination_bias_window", type=int, default=0)
    ap.add_argument("--multi_offset_prior", action="store_true")
    ap.add_argument("--multi_offset_prior_weights", default=None,
                    help='JSON dict offset→weight, e.g. \'{"4":0.1}\'')
    ap.add_argument("--allow_non_cds_tokens", action="store_true")
    ap.add_argument("--critic_guidance", action="store_true")
    ap.add_argument("--critic_ckpt", default=None)
    ap.add_argument("--critic_stability", action="store_true",
                    help="score generated proteins with the critic")
    ap.add_argument("--ebm_guidance", action="store_true")
    ap.add_argument("--ebm_ckpt", default=None)
    ap.add_argument("--guide_alpha", type=float, default=0.5)
    ap.add_argument("--guide_top_k", type=int, default=5)
    ap.add_argument("--target_protein", default=None,
                    help="AA string or FASTA path for synonymous generation")
    # audits
    ap.add_argument("--nll_controls", action="store_true",
                    help="score continuations vs shuffled/synonymous controls")
    ap.add_argument("--no_memorization_audit", action="store_false",
                    dest="memorization_audit")
    ap.add_argument("--memorization_n_list", default="10,20")
    ap.add_argument("--max_train_audit_tokens", type=int, default=10_000_000)
    # replay hookup
    ap.add_argument("--emit_replay", default=None,
                    help="write termination-replay JSONL from generated samples")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--run_root", default="runs")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def read_target_protein(raw: str | None) -> str | None:
    if not raw:
        return None
    path = Path(raw)
    if path.is_file():
        lines = [l.strip() for l in path.read_text().splitlines()
                 if l.strip() and not l.startswith(">")]
        return "".join(lines).upper()
    return raw.strip().upper()


def cds_from_rows(x, itos, max_genes: int) -> list[list[str]]:
    """Token rows → per-gene codon lists (first segment of each row)."""
    genes = []
    for row in x:
        codons = []
        for t in row:
            tok = itos[int(t)] if 0 <= int(t) < len(itos) else ""
            if tok == "<SEP>" or int(t) == 0:
                break
            if len(tok) == 3 and set(tok) <= set("ACGT"):
                codons.append(tok)
        if len(codons) >= 4:
            genes.append(codons)
        if len(genes) >= max_genes:
            break
    return genes


CRITIC_FLAGS = ("critic_guidance", "ebm_guidance", "critic_ckpt", "ebm_ckpt")


def refuse_critic_flags(args) -> None:
    """The critic and EBM scorers live in the protein stack, which is not
    ported: each of their flags raises instead of running without them."""
    used = [f"--{name}" for name in CRITIC_FLAGS if getattr(args, name)]
    if used:
        raise NotImplementedError(
            f"{', '.join(used)}: critic and EBM scoring (protein.critic_scoring, the "
            "protein stack) is not ported")


def main(argv=None) -> int:
    args = parse_args(argv)
    refuse_critic_flags(args)

    import numpy as np

    from genomics_lm_torch.data.datasets import PackedDataset
    from genomics_lm_torch.evals import gen_prefix as E
    from genomics_lm_torch.evals.playground import make_decoder
    from genomics_lm_torch.generation import constrained as G
    from genomics_lm_torch.utils.cli import resolve_run_dir

    preset = E.PRESETS[args.preset]
    max_genes = args.max_genes if args.max_genes is not None else preset["max_genes"]
    samples = args.samples if args.samples is not None else preset["samples"]
    max_new = args.max_new if args.max_new is not None else preset["max_new"]
    k_list = [int(v) for v in args.k_list.split(",") if v]

    run_dir = resolve_run_dir(args.run_id, args.run_root)
    out_dir = run_dir / "scores" / args.out_label
    out_dir.mkdir(parents=True, exist_ok=True)
    decoder, itos, stoi = make_decoder(run_dir, args.checkpoint, device=args.device)

    source_provenance = {"npz": str(args.npz), "binding": "unverified"}
    if args.dataset_manifest:
        from genomics_lm_torch.evals.provenance import bind_dataset_manifest

        _, manifest_prov = bind_dataset_manifest(
            args.dataset_manifest, require_scientific=False
        )
        source_provenance = {"npz": str(args.npz), "binding": manifest_prov}

    ds = PackedDataset(args.npz)
    x, _ = ds.fetch_batch(list(range(min(len(ds), 4 * max_genes))))
    genes = cds_from_rows(x, itos, max_genes)
    if not genes:
        raise SystemExit("[gen-prefix] no usable CDS rows in the split")

    train_paths = [args.train_npz] if args.train_npz else []
    unigram, codon_mask = E.fit_train_unigram(train_paths, itos)
    ngram_indexes = {}
    if args.memorization_audit and train_paths:
        ngram_indexes = E.build_train_ngram_indexes(
            train_paths,
            [int(v) for v in args.memorization_n_list.split(",") if v],
            max_tokens=args.max_train_audit_tokens,
        )

    target_protein = read_target_protein(args.target_protein)
    offset_weights = (
        {int(k): float(v) for k, v in
         json.loads(args.multi_offset_prior_weights).items()}
        if args.multi_offset_prior_weights else {}
    )

    guidance = []
    if target_protein:
        guidance.append("synonymous_template")
    if args.termination_bias:
        guidance.append("termination_bias")
    if args.multi_offset_prior:
        guidance.append("multi_offset_prior")
    if args.require_terminal_stop:
        guidance.append("forced_terminal_stop")
    if args.allow_non_cds_tokens:
        guidance.append("non_cds_tokens")
    is_guided = bool(guidance)

    block_size = decoder.cfg.block_size
    scored: list = []
    fasta_entries: list[tuple[str, str]] = []
    done, total = 0, len(genes) * len(k_list) * samples

    import time

    wall0 = time.perf_counter()
    for gene_idx, truth_codons in enumerate(genes):
        for k in k_list:
            prefix_codons = truth_codons[:k]
            ctx = [stoi["<BOS_CDS>"]] + [stoi[c] for c in prefix_codons if c in stoi]
            for sidx in range(samples):
                window = block_size - k - args.special_margin
                if window < args.min_aa_len:
                    raise SystemExit("block_size too small for requested k")
                hard_cap = int(min(window, args.max_aa_len, max_new))
                target_codons = max(
                    min(args.target_aa_len, hard_cap), args.min_aa_len
                )
                seed = E.derive_sample_seed(args.seed, gene_idx, k, sidx)

                def run_protocol(protocol: str):
                    rng = np.random.default_rng(seed)
                    if protocol == "raw_model":
                        return G.generate_model_raw(
                            decoder, ctx, stoi, itos, max_new_tokens=hard_cap,
                            temperature=args.temperature, topk=args.topk, rng=rng,
                        )
                    if protocol == "guided" and target_protein:
                        return G.generate_cds_synonymous(
                            decoder, ctx, stoi, itos, target_protein,
                            score_fn=None, alpha=0.0, guide_top_k=args.guide_top_k,
                            temperature=args.temperature, rng=rng,
                        )
                    # guided-without-critic and plain constrained share the core
                    biased = protocol == "guided"
                    return G.generate_cds_constrained(
                        decoder, ctx, stoi, itos,
                        target_codons=target_codons, hard_cap=hard_cap,
                        require_terminal_stop=args.require_terminal_stop and biased,
                        temperature=args.temperature, topk=args.topk,
                        termination_bias_enabled=args.termination_bias and biased,
                        termination_stop_bias=args.termination_stop_bias,
                        termination_trigger_class_max=args.termination_trigger_class_max,
                        termination_bias_window=args.termination_bias_window,
                        cds_only=not (args.allow_non_cds_tokens and biased),
                        multi_offset_prior_enabled=args.multi_offset_prior and biased,
                        multi_offset_prior_weights=offset_weights or None,
                        rng=rng,
                    )

                protocols = ["raw_model", "cds_constrained"]
                if is_guided:
                    protocols.append("guided")
                for protocol in protocols:
                    ids, info = run_protocol(protocol)
                    sample = E.score_sample(
                        decoder=decoder, protocol=protocol,
                        gene_idx=gene_idx, k=k, sample_id=sidx,
                        sample_seed=seed, generated_ids=ids,
                        prefix_len_tokens=len(ctx), info=info,
                        truth_codons=truth_codons, itos=itos, stoi=stoi,
                        unigram=unigram, codon_mask=codon_mask,
                        ngram_indexes=ngram_indexes,
                        nll_controls=args.nll_controls,
                    )
                    scored.append(sample)
                    fasta_entries.append((
                        f"{protocol}_gene{gene_idx}_k{k}_sample{sidx}_seed{seed}",
                        "".join(sample.codons),
                    ))
                done += 1
                if args.progress_every and done % args.progress_every == 0:
                    rate = done / max(time.perf_counter() - wall0, 1e-9)
                    print(f"[gen-prefix] progress {done}/{total} "
                          f"rate={rate:.2f} samples/sec", flush=True)

    # --- outputs --------------------------------------------------------
    def sample_row(s):
        return {
            "run_id": run_dir.name, "protocol": s.protocol,
            "gene_idx": s.gene_idx, "k": s.k, "sample_id": s.sample_id,
            "sample_seed": s.sample_seed,
            **{name: s.metrics[name] for name in sorted(s.metrics)},
            "stop_reason": s.info.get("stop_reason", ""),
            "guidance_components": ";".join(guidance) if s.protocol == "guided" else "",
        }

    all_rows = [sample_row(s) for s in scored]
    E.write_csv(out_dir / "protocol_samples.csv", all_rows)
    E.write_csv(
        out_dir / "samples.csv",
        [r for r in all_rows
         if r["protocol"] == ("guided" if is_guided else "cds_constrained")],
    )
    E.write_fasta(out_dir / "generated_protocols.fasta", fasta_entries)

    protocols = ("raw_model", "cds_constrained", "guided")
    summary = E.summarize_by_k(
        scored, k_list, protocols, base_seed=args.seed,
        ci_resamples=args.ci_resamples,
    )
    E.write_csv(out_dir / "protocol_summary.csv", summary)
    E.write_csv(
        out_dir / "summary.csv",
        [r for r in summary
         if r["protocol"] == ("guided" if is_guided else "cds_constrained")],
    )

    manifest = {
        "schema_version": 1,
        "run_id": run_dir.name,
        "source_data": source_provenance,
        "base_seed": int(args.seed),
        "sample_seed_derivation": "sha256(base_seed:gene_idx:k:sample_id)[0:4]",
        "confidence_interval": {
            "method": "percentile_bootstrap", "level": 0.95,
            "resamples": int(args.ci_resamples),
        },
        "decoding": {
            "temperature": float(args.temperature), "topk": int(args.topk),
            "guide_top_k": int(args.guide_top_k), "max_new": int(max_new),
        },
        "protocols": {
            "raw_model": {"full_vocabulary": True,
                          "forced_terminal_stop": False,
                          "guidance_components": []},
            "cds_constrained": {"full_vocabulary": False,
                                "forced_terminal_stop": False,
                                "guidance_components": []},
            **({"guided": {"full_vocabulary": bool(args.allow_non_cds_tokens),
                           "forced_terminal_stop": bool(args.require_terminal_stop),
                           "guidance_components": guidance}}
               if is_guided else {}),
        },
        "audits": {
            "nll_controls": bool(args.nll_controls),
            "memorization_n": sorted(ngram_indexes),
        },
    }
    (out_dir / "protocol_manifest.json").write_text(
        json.dumps(manifest, indent=2, sort_keys=True) + "\n"
    )

    try:
        E.plot_summary(summary, out_dir)
    except Exception as exc:  # plotting must never kill the benchmark
        print(f"[gen-prefix] plotting failed: {exc}")

    if args.emit_replay:
        records = E.replay_records(scored, stoi)
        replay_path = Path(args.emit_replay)
        replay_path.parent.mkdir(parents=True, exist_ok=True)
        with replay_path.open("w") as fh:
            for record in records:
                fh.write(json.dumps(record) + "\n")
        print(f"[gen-prefix] wrote {len(records)} replay records → {replay_path}")

    headline = [r for r in summary if r["protocol"] != "raw_model"]
    print(json.dumps({"out_dir": str(out_dir), "n_samples": len(scored),
                      "summary_rows": len(summary),
                      "median_gqs_by_k": {r["k"]: r["median_gqs"]
                                          for r in headline}}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
