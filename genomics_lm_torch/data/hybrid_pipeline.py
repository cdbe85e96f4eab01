"""Hybrid (multi-scale) dataset pipeline: GBFF → training-ready artifacts
(the port's own copy of ``genomics_lm_tpu/data/hybrid_pipeline.py``, numpy
only; every artifact equals the JAX package's, ``tests/test_torch_hybrid_pipeline.py``).

Covers the reference's full hybrid preparation flow
(``src/codonlm/pipeline_prepare_hybrid.py:1-421``): per-CDS flanked-window
extraction (``src/codonlm/extract_hybrid_from_genbank.py``), hybrid
tokenization (``src/codonlm/hybrid_tokenize.py``), genome-group split +
lossless packing (``src/codonlm/build_dataset.py``), cross-dataset stacking,
manifest emission, and the pad-only-window integrity gate.

Unlike the reference — which chains ``python -m`` subprocesses per stage —
every stage here is an in-process library function composed by
:func:`prepare_hybrid_datasets`; the CLI (``data/pipeline_prepare_hybrid.py``)
is a thin argument adapter. Artifact names and layouts match the reference so
its consumers (trainer, dashboards) find the same files:

    <out_root>/<name>_hybrid/{hybrid_data.tsv, hybrid_meta.tsv,
        hybrid_ids.txt, vocab_hybrid.txt, itos_hybrid.txt,
        {train,val,test}_bs<B>.npz}
    <out_root>/combined_hybrid/<run_id>/{train,val,test}_bs<B>.npz + manifest.json
    <run_dir>/{datasets_manifest.json, combined_manifest.json,
        pipeline_prepare.json, integrity.json}

The combined dataset directory additionally carries ``itos.txt`` (the
74-token hybrid vocabulary) so the production trainer's vocabulary contract
binds it with no extra configuration — a hybrid model trains end-to-end from
GBFF in one ``prepare → run_training`` sequence.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

from genomics_lm_torch.data.genbank import parse_genbank, reverse_complement
from genomics_lm_torch.data.packing import chunk_record, pack_chunks, packed_arrays
from genomics_lm_torch.data.pipeline import SPLITS, assign_group_splits
from genomics_lm_torch.tokenizers.hybrid import HybridTokenizer

# Reference parity: build_dataset.py packs every vocabulary with separator
# id 3 (`pack_chunks(..., sep_id=3)`, reference build_dataset.py:139). In the
# 68-token codon vocabulary id 3 is <SEP>; in the 74-token hybrid vocabulary
# id 3 is <UNK> — the reference knowingly reuses it as the packing separator.
# We keep the same id so packed arrays are layout-compatible, and document
# the quirk here instead of hiding it.
HYBRID_PACK_SEP_ID = 3

EXPECTED_HYBRID_SPECIALS = [
    "<PAD>", "<BOS_CDS>", "<EOS_CDS>", "<UNK>", "<UTR_START>", "<UTR_END>",
]


class HybridPipelineError(RuntimeError):
    """Configuration or stage failure in the hybrid dataset pipeline."""


class HybridIntegrityError(HybridPipelineError):
    """Prepared arrays violate the integrity contract (pad-only windows)."""


def genome_id_from_path(path: str | Path) -> str:
    """Stable genome identity from a GBFF filename stem.

    Mirrors the reference's convention (extract_hybrid_from_genbank.py:36-40):
    join the first two underscore-separated stem parts (e.g. the assembly
    accession ``GCF_000005845``), else the whole stem.
    """
    parts = Path(path).stem.split("_")
    return "_".join(parts[:2]) if len(parts) >= 2 else parts[0]


def extract_hybrid_flanked(
    gbff_paths: Sequence[str | Path],
    *,
    min_len: int = 90,
    upstream: int = 30,
    downstream: int = 60,
) -> list[dict]:
    """Per-CDS flanked windows in transcription orientation.

    For each CDS of length ≥ ``min_len`` nt, extract ``upstream`` nt of
    5'-flank + CDS + ``downstream`` nt of 3'-flank; minus-strand features are
    reverse-complemented so the window always reads in coding orientation,
    with the CDS boundaries re-expressed in window coordinates. Windows with
    characters outside ACGTN are dropped (reference
    extract_hybrid_from_genbank.py:46-85).
    """
    allowed = set("ACGTN")
    rows: list[dict] = []
    for path in gbff_paths:
        genome = genome_id_from_path(path)
        for record in parse_genbank(path):
            seq = record.sequence.upper()
            seq_len = len(seq)
            for cds in record.cds_features:
                if not cds.intervals:
                    continue
                start = cds.intervals[0][0]
                end = cds.intervals[-1][1]
                if end - start < min_len:
                    continue
                if cds.strand != "-":
                    lo = max(0, start - upstream)
                    hi = min(seq_len, end + downstream)
                    window = seq[lo:hi]
                    cds_start, cds_end = start - lo, end - lo
                else:
                    lo = max(0, start - downstream)
                    hi = min(seq_len, end + upstream)
                    window = reverse_complement(seq[lo:hi]).upper()
                    cds_start, cds_end = hi - end, hi - start
                if set(window) <= allowed:
                    rows.append({
                        "line_idx": len(rows),
                        "genome": genome,
                        "sequence": window,
                        "cds_start": cds_start,
                        "cds_end": cds_end,
                    })
    return rows


def tokenize_hybrid_flanked(
    records: Sequence[Mapping[str, Any]],
    tokenizer: HybridTokenizer | None = None,
) -> tuple[list[list[int]], list[str]]:
    """Flanked windows → hybrid token-id lines (+ aligned genome labels).

    The extracted window is already transcription-oriented, so the CDS
    interval is always encoded on the '+' strand
    (reference hybrid_tokenize.py:39-41). Records that tokenize to nothing
    are dropped, keeping ids and genome labels aligned.
    """
    tok = tokenizer or HybridTokenizer()
    lines: list[list[int]] = []
    genomes: list[str] = []
    for rec in records:
        interval = (int(rec["cds_start"]), int(rec["cds_end"]), "+")
        ids = tok.encode(str(rec["sequence"]), [interval])
        if ids:
            lines.append(ids)
            genomes.append(str(rec["genome"]))
    return lines, genomes


def _write_dataset_files(out_dir: Path, rows: list[dict],
                         lines: list[list[int]], tok: HybridTokenizer) -> None:
    """TSV/meta/ids/vocab/itos artifacts matching the reference layout."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with (out_dir / "hybrid_data.tsv").open("w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["line_idx", "genome", "sequence", "cds_start", "cds_end"],
            delimiter="\t")
        writer.writeheader()
        writer.writerows(rows)
    (out_dir / "hybrid_meta.tsv").write_text(
        "line_idx\tgenome\n"
        + "".join(f"{r['line_idx']}\t{r['genome']}\n" for r in rows))
    (out_dir / "hybrid_ids.txt").write_text(
        "".join(" ".join(map(str, ids)) + "\n" for ids in lines))
    (out_dir / "vocab_hybrid.txt").write_text(
        "".join(f"{i}\t{t}\n" for i, t in enumerate(tok.vocab)))
    (out_dir / "itos_hybrid.txt").write_text("\n".join(tok.vocab) + "\n")


def build_hybrid_splits(
    token_lines: Sequence[Sequence[int]],
    genomes: Sequence[str],
    out_dir: str | Path,
    *,
    block_size: int,
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 1337,
    pack_mode: str = "multi",
) -> dict:
    """Group split by genome + lossless packing → {split}_bs{B}.npz.

    Reuses the shared split policy (sequence fallback below 3 genome groups,
    reference build_dataset.py:99-125) and the transition-exact packer. The
    ``binpack`` mode is accepted as the repo's padding-minimizing extension.
    """
    if len(token_lines) != len(genomes):
        raise HybridPipelineError("token lines and genome labels must align")
    records = [
        {"source_id": f"line:{i}", "genome": genomes[i]}
        for i in range(len(token_lines))
    ]
    records, policy = assign_group_splits(
        records, group_by="genome",
        fractions={"val": val_frac, "test": test_frac},
        seed=seed, allow_sequence_split=True,
    )
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    array_mode = "dynamic" if pack_mode == "dynamic" else "fixed"
    counts = {}
    for split in SPLITS:
        split_records = [
            {
                "tokens": token_lines[i],
                "source_id": f"line:{i}",
                "source_line_idx": i,
                "fragment_line_idx": i,
                "fragment_index": 0,
                "split": split,
                "fragment_codon_start": 0,
                "fragment_codon_end": max(0, len(token_lines[i]) - 2),
            }
            for i, rec in enumerate(records)
            if rec["split"] == split
        ]
        chunks = [c for r in split_records for c in chunk_record(r, block_size)]
        windows = pack_chunks(chunks, block_size=block_size, mode=pack_mode,
                              sep_id=HYBRID_PACK_SEP_ID)
        arrays = packed_arrays(windows, block_size=block_size, mode=array_mode)
        np.savez_compressed(out_dir / f"{split}_bs{block_size}.npz", **arrays)
        counts[split] = len(windows)
    return {"split_policy": policy, "window_counts": counts}


def count_pad_only_windows(npz_path: str | Path) -> int:
    """Windows whose every target is <PAD> (would train to non-finite loss).

    Returns -1 if the file is unreadable (reference
    pipeline_prepare_hybrid.py:382-389). Dynamic-mode packs have no pad and
    report 0.
    """
    try:
        with np.load(npz_path, allow_pickle=False) as blob:
            if "Y" not in blob:
                return 0
            Y = np.asarray(blob["Y"])
            return int(((Y != 0).sum(axis=1) == 0).sum())
    except Exception:
        return -1


def _stack_splits(dataset_dirs: Sequence[Path], combined_dir: Path,
                  block_size: int) -> dict[str, Path]:
    """Row-concatenate per-dataset packs into the combined dataset."""
    combined_dir.mkdir(parents=True, exist_ok=True)
    out_paths: dict[str, Path] = {}
    for split in SPLITS:
        per_key: dict[str, list[np.ndarray]] = {}
        for ds_dir in dataset_dirs:
            with np.load(ds_dir / f"{split}_bs{block_size}.npz",
                         allow_pickle=False) as blob:
                for key in blob.files:
                    per_key.setdefault(key, []).append(np.asarray(blob[key]))
        stacked = {k: np.concatenate(v, axis=0) if v else np.zeros((0, block_size))
                   for k, v in per_key.items()}
        out = combined_dir / f"{split}_bs{block_size}.npz"
        np.savez_compressed(out, **stacked)
        out_paths[split] = out
    return out_paths


def _dataset_entry(name: str, gbff: str | Path, out_root: Path,
                   block_size: int, min_len: int) -> dict[str, Any]:
    out_dir = out_root / f"{name}_hybrid"
    return {
        "name": name,
        "gbff": str(gbff),
        "min_len": int(min_len),
        "out_dir": str(out_dir),
        "tsv": str(out_dir / "hybrid_data.tsv"),
        "meta": str(out_dir / "hybrid_meta.tsv"),
        "ids": str(out_dir / "hybrid_ids.txt"),
        "vocab": str(out_dir / "vocab_hybrid.txt"),
        "itos": str(out_dir / "itos_hybrid.txt"),
        "train": str(out_dir / f"train_bs{block_size}.npz"),
        "val": str(out_dir / f"val_bs{block_size}.npz"),
        "test": str(out_dir / f"test_bs{block_size}.npz"),
    }


def _itos_state(datasets: Sequence[Mapping[str, Any]]) -> dict:
    """Cross-dataset tokenization consistency (reference :294-332).

    A mix of tokenized and untokenized datasets, legacy/incompatible itos
    specials, or itos disagreement across datasets all force re-tokenization
    of everything — a stale vocabulary silently corrupts every id.
    """
    needs, has, itos_heads = [], [], []
    for ds in datasets:
        (has if Path(ds["ids"]).exists() else needs).append(ds["name"])
        itos_p = Path(ds["itos"])
        if itos_p.exists():
            toks = [t.strip() for t in itos_p.read_text().splitlines() if t.strip()]
            itos_heads.append(toks[:6])
    mixed = bool(needs) and bool(has)
    bad_specials = any(head != EXPECTED_HYBRID_SPECIALS for head in itos_heads)
    inconsistent = len({tuple(h) for h in itos_heads}) > 1
    return {
        "mixed_state": mixed,
        "bad_specials": bad_specials,
        "inconsistent_itos": inconsistent,
        "force_retokenize": mixed or bad_specials or inconsistent,
    }


def prepare_hybrid_datasets(
    cfg: Mapping[str, Any],
    run_dir: str | Path,
    run_id: str,
    *,
    out_root: str | Path = "data/processed",
    upstream: int = 30,
    downstream: int = 60,
    force: bool = False,
    extra_datasets: Sequence[Mapping[str, Any]] = (),
    pack_mode: str = "multi",
) -> dict:
    """Config-driven hybrid preparation: GBFF → combined training dataset.

    ``cfg`` carries ``datasets: [{name, gbff[, min_len]}]`` plus
    ``block_size / windows_per_seq / val_frac / test_frac`` (optionally under
    a ``data:`` sub-map, merged flat like the reference's ``_load_config``).
    Stages already on disk are skipped unless ``force`` or the cross-dataset
    tokenization-state checks demand a rebuild. Raises
    :class:`HybridIntegrityError` when any combined split contains pad-only
    windows. Returns the ``pipeline_prepare.json`` result dict.
    """
    cfg = dict(cfg)
    data_map = cfg.get("data")
    if isinstance(data_map, dict):
        for k, v in data_map.items():
            cfg.setdefault(k, v)

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out_root = Path(out_root)

    block_size = int(cfg.get("block_size", 256))
    windows_per_seq = cfg.get("windows_per_seq", 2)
    try:
        windows_per_seq = int(float(windows_per_seq))
    except (TypeError, ValueError):
        raise HybridPipelineError(
            f"windows_per_seq must be numeric, got {windows_per_seq!r}")
    if windows_per_seq <= 0:
        raise HybridPipelineError(
            f"windows_per_seq must be positive, got {windows_per_seq}")
    val_frac = float(cfg.get("val_frac", 0.1))
    test_frac = float(cfg.get("test_frac", 0.1))
    seed = int(cfg.get("seed", 1337))

    datasets: list[dict] = []
    for entry in list(cfg.get("datasets", [])) + list(extra_datasets):
        missing = [k for k in ("name", "gbff") if k not in entry]
        if missing:
            raise HybridPipelineError(
                f"dataset entry missing keys {missing}: {dict(entry)}")
        if not Path(entry["gbff"]).exists():
            raise HybridPipelineError(f"GBFF not found: {entry['gbff']}")
        datasets.append(_dataset_entry(
            str(entry["name"]), entry["gbff"], out_root, block_size,
            int(entry.get("min_len", 90))))
    if not datasets:
        raise HybridPipelineError("no datasets specified (config + CLI empty)")

    (run_dir / "datasets_manifest.json").write_text(json.dumps({
        "datasets": datasets,
        "block_size": block_size,
        "windows_per_seq": windows_per_seq,
        "val_frac": val_frac,
        "test_frac": test_frac,
        "upstream": upstream,
        "downstream": downstream,
        "force": int(bool(force)),
    }, indent=2))

    state = _itos_state(datasets)
    force_all = bool(force or state["force_retokenize"])
    tokenizer = HybridTokenizer()
    stage_log: list[dict] = []
    for ds in datasets:
        built = all(Path(ds[k]).exists() for k in ("train", "val", "test"))
        tokenized = Path(ds["ids"]).exists() and Path(ds["itos"]).exists()
        # artifacts are reusable only when built under the SAME parameters —
        # existence alone would silently stack stale packs after a
        # pack_mode/flank/split change (and could mix array layouts)
        fingerprint = {
            "min_len": ds["min_len"],
            "upstream": int(upstream),
            "downstream": int(downstream),
            "block_size": block_size,
            "val_frac": val_frac,
            "test_frac": test_frac,
            "seed": seed,
            "pack_mode": pack_mode,
        }
        fp_path = Path(ds["out_dir"]) / "build_params.json"
        try:
            params_match = json.loads(fp_path.read_text()) == fingerprint
        except (OSError, json.JSONDecodeError):
            params_match = False
        if force_all or not (built and tokenized and params_match):
            # invalidate BEFORE touching artifacts: an interrupted rebuild
            # must not leave the old fingerprint validating a mixed set
            fp_path.unlink(missing_ok=True)
            rows = extract_hybrid_flanked(
                [ds["gbff"]], min_len=ds["min_len"],
                upstream=upstream, downstream=downstream)
            lines, genomes = tokenize_hybrid_flanked(rows, tokenizer)
            _write_dataset_files(Path(ds["out_dir"]), rows, lines, tokenizer)
            build = build_hybrid_splits(
                lines, genomes, ds["out_dir"], block_size=block_size,
                val_frac=val_frac, test_frac=test_frac, seed=seed,
                pack_mode=pack_mode)
            fp_path.write_text(json.dumps(fingerprint, indent=2))
            stage_log.append({"name": ds["name"], "rebuilt": True,
                              "records": len(lines), **build})
        else:
            stage_log.append({"name": ds["name"], "rebuilt": False})

    combined_dir = out_root / "combined_hybrid" / run_id
    split_paths = _stack_splits(
        [Path(ds["out_dir"]) for ds in datasets], combined_dir, block_size)
    # the trainer's vocabulary contract binds the dataset-adjacent itos.txt
    (combined_dir / "itos.txt").write_text("\n".join(tokenizer.vocab) + "\n")

    combined_manifest = {
        "train": str(split_paths["train"]),
        "val": str(split_paths["val"]),
        "test": str(split_paths["test"]),
        "datasets": datasets,
    }
    (combined_dir / "manifest.json").write_text(
        json.dumps(combined_manifest, indent=2))
    (run_dir / "combined_manifest.json").write_text(
        json.dumps(combined_manifest, indent=2))

    result = {
        "train_npz": str(split_paths["train"]),
        "val_npz": str(split_paths["val"]),
        "test_npz": str(split_paths["test"]),
        "itos": str(combined_dir / "itos.txt"),
        "primary_dna": datasets[0]["tsv"],
        "combined_manifest": str(combined_dir / "manifest.json"),
        "stages": stage_log,
        "tokenization_state": state,
    }
    (run_dir / "pipeline_prepare.json").write_text(json.dumps(result, indent=2))

    empty = {split: count_pad_only_windows(split_paths[split]) for split in SPLITS}
    (run_dir / "integrity.json").write_text(json.dumps({
        "train_npz": result["train_npz"],
        "val_npz": result["val_npz"],
        "test_npz": result["test_npz"],
        "empty_windows": empty,
    }, indent=2))
    if any(v > 0 for v in empty.values()):
        raise HybridIntegrityError(
            "pad-only windows detected (would produce non-finite losses): "
            f"{empty}; re-run with force=True or adjust block_size")
    return result


__all__ = [
    "EXPECTED_HYBRID_SPECIALS",
    "HYBRID_PACK_SEP_ID",
    "HybridIntegrityError",
    "HybridPipelineError",
    "build_hybrid_splits",
    "count_pad_only_windows",
    "extract_hybrid_flanked",
    "genome_id_from_path",
    "prepare_hybrid_datasets",
    "tokenize_hybrid_flanked",
]
