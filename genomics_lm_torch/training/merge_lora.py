"""Fold LoRA adapters into base weights (twin of ``scripts/merge_lora.py``).

    python -m genomics_lm_torch.training.merge_lora runs/<id>/checkpoints/best.npz merged.npz

The output is a plain dense checkpoint that every consumer of either
package reads (``params_from_jax``, ``ServingEngine``, the JAX loaders).
The optimizer state is dropped (it is adapter-shaped) and so are the
``lora_*`` keys of the run config, so a run seeded from the merged
checkpoint neither re-attaches adapters nor freezes the backbone.
Everything else is carried over untouched. Exits 2 on a checkpoint without
adapters.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Merge LoRA adapters into a dense checkpoint")
    ap.add_argument("checkpoint", help="checkpoint with LoRA adapter leaves")
    ap.add_argument("out", help="merged dense checkpoint to write")
    args = ap.parse_args(argv)

    from genomics_lm_torch.training import checkpoints as ckpt_lib
    from genomics_lm_torch.training.lora import has_lora, merge_lora

    payload = ckpt_lib.load_checkpoint(args.checkpoint)
    if not has_lora(payload["model"]):
        print(f"error: {args.checkpoint} has no LoRA adapters", file=sys.stderr)
        return 2
    payload = dict(payload)
    payload["model"] = merge_lora(payload["model"])
    payload.pop("optimizer", None)
    if isinstance(payload.get("cfg"), dict):
        payload["cfg"] = {
            k: v for k, v in payload["cfg"].items() if not k.startswith("lora_")
        }
    ckpt_lib.save_checkpoint(payload, args.out)
    print(f"[merge_lora] wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
