"""Verify a frozen corrected-dataset release (twin of
``scripts/verify_dataset_freeze.py``, the same arguments). Host only.

    python -m genomics_lm_torch.data.verify_dataset_freeze <out_root>/<release>

Every protocol's manifest must validate with its artifacts' hashes and
carry the dataset id ``freeze.json`` recorded, and the freeze id must be
the sha256 over those ids (``freeze_corrected_datasets.freeze_id``). Exit 0
and one ``OK`` line, or exit 1 and one ``FAIL`` line per fault.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("release_dir", help="corrected/<release> directory")
    args = ap.parse_args(argv)

    from genomics_lm_torch.data.freeze_corrected_datasets import freeze_id
    from genomics_lm_torch.data.manifest import load_dataset_manifest

    release_dir = Path(args.release_dir)
    freeze = json.loads((release_dir / "freeze.json").read_text())
    failures = []
    for name, info in freeze["protocols"].items():
        root = release_dir / name
        try:
            manifest = load_dataset_manifest(root / "manifest.json", verify_artifacts=True)
        except Exception as exc:
            failures.append(f"{name}: manifest validation failed: {exc}")
            continue
        if manifest["dataset"]["id"] != info["dataset_id"]:
            failures.append(
                f"{name}: dataset id drift {manifest['dataset']['id']} != {info['dataset_id']}"
            )
    recomputed = freeze_id(freeze["protocols"])
    if recomputed != freeze["dataset_freeze_id"]:
        failures.append(
            f"freeze id drift: {recomputed} != {freeze['dataset_freeze_id']}"
        )
    if failures:
        for failure in failures:
            print(f"[verify] FAIL {failure}")
        return 1
    print(f"[verify] OK release={freeze['release']} freeze_id={freeze['dataset_freeze_id']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
