"""Freeze prepared datasets into a corrected release directory (twin of
``scripts/freeze_corrected_datasets.py``, the same flags). Host only.

    python -m genomics_lm_torch.data.freeze_corrected_datasets \\
        --release corrected-codonlm-v1 --protocol p512 <dataset dir> \\
        [--protocol NAME DIR ...] [--out_root data/processed/corrected] [--read_only]

Each protocol's prepared dataset (its ``manifest.json`` validated with its
artifacts' hashes, ``data/manifest.py``) is copied to
``<out_root>/<release>/<protocol>/``; ``freeze.json`` records the release,
each protocol's dataset id, and the freeze id: the sha256 over the JSON of
``{protocol: dataset id}`` with sorted keys. ``--read_only`` makes every
copied file mode 0444. An existing protocol directory is never overwritten.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
from pathlib import Path


def freeze_id(protocols: dict) -> str:
    """The release's id: sha256 over the protocols' dataset ids."""
    return hashlib.sha256(
        json.dumps(
            {k: v["dataset_id"] for k, v in sorted(protocols.items())},
            sort_keys=True,
        ).encode()
    ).hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--release", required=True, help="release name, e.g. corrected-codonlm-v1")
    ap.add_argument("--protocol", action="append", nargs=2, required=True,
                    metavar=("NAME", "DATASET_DIR"),
                    help="protocol name + prepared dataset dir (repeatable)")
    ap.add_argument("--out_root", default="data/processed/corrected")
    ap.add_argument("--read_only", action="store_true")
    args = ap.parse_args(argv)

    from genomics_lm_torch.data.manifest import load_dataset_manifest

    release_dir = Path(args.out_root) / args.release
    release_dir.mkdir(parents=True, exist_ok=True)
    protocols = {}
    for name, src in args.protocol:
        src = Path(src)
        manifest = load_dataset_manifest(src / "manifest.json", verify_artifacts=True)
        dst = release_dir / name
        if dst.exists():
            raise SystemExit(f"refusing to overwrite existing freeze: {dst}")
        shutil.copytree(src, dst)
        protocols[name] = {
            "dataset_id": manifest["dataset"]["id"],
            "root": str(dst),
            "scientific_valid": manifest["dataset"].get("scientific_valid", False),
        }
        if args.read_only:
            for path in dst.rglob("*"):
                if path.is_file():
                    os.chmod(path, 0o444)

    fid = freeze_id(protocols)
    freeze = {
        "schema": {"name": "codonlm_dataset_freeze", "version": 1},
        "release": args.release,
        "dataset_freeze_id": fid,
        "protocols": protocols,
    }
    (release_dir / "freeze.json").write_text(json.dumps(freeze, indent=2, sort_keys=True) + "\n")
    print(f"[freeze] release={args.release} freeze_id={fid}")
    for name, info in protocols.items():
        print(f"[freeze]   {name}: {info['dataset_id']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
