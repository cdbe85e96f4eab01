"""Serve a trained codon LM over HTTP with continuous batching (twin of
``scripts/serve_model.py``, the same flags, plus ``--device``).

    python -m genomics_lm_torch.serving.serve_model --run runs/<id> [--port 8000] \
        [--slots 64] [--max_seq_len 256] [--kv_quant] [--int8_weights] \
        [--speculative K [--draft_npz train.npz]] [--device cpu]

Endpoints (``serving/server.py``):
    POST /generate  {"dna": "ATG...", "max_new_tokens": 64,
                     "temperature": 0.8, "stop_ids": [2], "stream": false}
                    — or "prompt": [token ids] instead of "dna"
    GET  /stats     scheduler snapshot
    GET  /health    liveness

The model loads from the run directory (``evals/playground.py``) onto the
card unless ``--device`` names another; ``--int8_weights`` quantizes its
block linears (``ops/quant.py::quantize_params``); ``--speculative K``
fits the bigram draft table on ``--draft_npz`` or on the ``train_npz`` of
the run's ``checkpoints/config.yaml``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True, help="run directory (or checkpoint)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint name inside the run (default best/last)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--max_seq_len", type=int, default=None)
    ap.add_argument("--steps_per_sync", type=int, default=16)
    ap.add_argument("--kv_quant", action="store_true")
    ap.add_argument("--int8_weights", action="store_true")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="exact speculative decoding with K bigram-drafted "
                         "tokens per verify round; the draft table is fitted "
                         "to the run's training dataset (or --draft_npz)")
    ap.add_argument("--draft_npz", default=None,
                    help="packed NPZ to fit the bigram draft table on "
                         "(default: the run's train_npz from its config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap


def draft_corpus(run: str, draft_npz: str | None) -> str:
    """The packed NPZ the draft table is fitted on: ``--draft_npz`` or the
    first ``train_npz`` of the run's ``checkpoints/config.yaml``."""
    if draft_npz is not None:
        return draft_npz
    import yaml

    run_cfg = Path(run) / "checkpoints" / "config.yaml"
    if not run_cfg.exists():
        raise SystemExit(
            "--speculative needs a corpus for the draft table: pass "
            "--draft_npz or serve a run whose checkpoints/config.yaml "
            "records train_npz")
    npz_path = yaml.safe_load(run_cfg.read_text()).get("train_npz")
    if isinstance(npz_path, (list, tuple)):
        npz_path = npz_path[0] if npz_path else None
    if not npz_path or not Path(str(npz_path).split(",")[0]).exists():
        raise SystemExit(f"train_npz from the run config is unavailable ({npz_path!r}); "
                         "pass --draft_npz")
    return str(npz_path).split(",")[0]


def build_server(args):
    """The ``InferenceServer`` (not started) over an engine serving the run."""
    import numpy as np

    from genomics_lm_torch.evals.playground import load_codon_model
    from genomics_lm_torch.ops.quant import quantize_params
    from genomics_lm_torch.serving.engine import ServingEngine
    from genomics_lm_torch.serving.server import InferenceServer
    from genomics_lm_torch.serving.speculative import fit_bigram_table

    model, cfg, _, _ = load_codon_model(args.run, args.checkpoint, device=args.device)
    cfg = cfg.replace(dropout=0.0)
    if args.int8_weights:
        model = quantize_params(model)
    spec_kw = {}
    if args.speculative:
        npz_path = draft_corpus(args.run, args.draft_npz)
        X = np.load(npz_path)["X"]
        spec_kw = {"speculative_k": args.speculative,
                   "draft_table": fit_bigram_table(X, cfg.vocab_size, exclude_ids=(0,))}
        print(f"[serve] speculative K={args.speculative}, draft table fitted on {npz_path}",
              flush=True)
    engine = ServingEngine(
        model, cfg, slots=args.slots, max_seq_len=args.max_seq_len,
        kv_quant=args.kv_quant, steps_per_sync=args.steps_per_sync,
        seed=args.seed, device=args.device, **spec_kw)
    return InferenceServer(engine, host=args.host, port=args.port)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    server = build_server(args)
    server.start()
    host, port = server.address
    print(f"[serve] listening on http://{host}:{port} "
          f"(slots={args.slots}, kv_quant={args.kv_quant}, "
          f"int8_weights={args.int8_weights})", flush=True)
    try:
        server._http_thread.join()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
