#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports the port (``genomics_lm_torch``) and never JAX, and runs these
phases, each printing its findings on its own line; any failure raises and
exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``), CUDA version.
2. build   — compiles every kernel of the serving and training paths from
   ``csrc/`` with nvcc for sm_90a (one nvcc per source, all started
   together); logs the registers and spills of each bf16 tensor-core
   kernel (flash forward, dQ and dK/dV; verify chunk) and of each
   bf16-query single-token tile kernel (decode, streamed).
3. kernel  — the decode-attention kernel against its plain PyTorch version
   on the card at the serving shapes (bf16 and int8 caches, MHA and GQA,
   off-grid and unvectorizable shapes, the serving drain's lengths, every
   slot full), and again with every dead cache tile (``decode_live_tiles``)
   set to NaN, which a read would carry into the output; then its time
   beside the bound of the positions its mask needs (also logged: the
   tiles read of the total, their bound and the full cache's), the plain
   version's time and one library call's time.
4. serve   — the serving main path: ``ServingEngine`` at the full width of
   the 10L8H d384 CodonGPT (block 512, bf16, fused QKV, random weights
   from a seed) drains 128 requests; the decode kernel's launch count is
   reset just before and read just after, and must match the decode
   steps. One more drain runs the int8 KV cache.
5. parity  — a 2-layer float32 model gives identical greedy tokens on the
   card (kernel) and on the CPU (plain path).
6. http    — ``InferenceServer`` answers /generate (plain and streamed)
   and /stats on an ephemeral localhost port.
7. flash   — the flash-attention forward, dQ and dK/dV kernels against
   their plain versions (O, LSE, and the gradients of a fixed cotangent)
   at the training shape with and without dropout, GQA, a window, suffix
   queries, an off-grid length, and float32 with and without the causal
   mask; for the bf16 tensor-core kernels also a segment every 4th token at
   dropout 0.5, random non-monotone ids, D 20/64/128, GQA 4:1 with a window
   off the grid, and non-causal; and at the LoRA fine-tuning path's width
   (B 8, H 8, T 512, heads of 64: MHA with dropout and ``<SEP>`` segments,
   and GQA 4:1); each case logs the tiles the kernels visit
   (``flash_live_tiles``) beside the band's. Then each kernel's time beside
   its bound, its plain version's time and one library call's, at the
   training shape and at d512.
8. train   — the training main path (``training/profile_step.py``): the
   same CodonGPT with dropout 0.1 and label smoothing, AdamW in two LR
   groups, 3 warm-up and 10 measured groups of 16 x 8 x 512 tokens; every
   loss finite, every group applied, and each flash kernel's launch count,
   reset just before the measured groups and read just after, equal to
   16 microbatches x 10 layers x 10 groups.
9. train parity — a 2-layer float32 model takes one group step on the
   card (kernels) and on the CPU (plain versions) from the same weights
   and batch; loss, gradients and updated parameters agree. Then again
   with every objective and option of the fine-tuning slice: two offset
   heads, the termination and replay losses, shape guidance through the
   encoder, LoRA r8 under ``lora_only``, Adafactor and an active
   ``grad_clip``.
10. chunk  — the verify-chunk kernel against its plain version at the
   speculative shape (T 5 queries per slot over a 384-position cache, bf16
   and int8, random lengths and every slot full), GQA, T 1 and T 8, an
   off-grid cache, D 20, a mask with a segment gap under the intra-chunk
   staircase, and 32 rows at D 128 over int8; the bf16-query kernel held to
   a bound per output element, which a skipped live tile and another slot's
   mask rows must exceed. Each case logs the cache tiles read
   (``chunk_live_tiles``) beside the total. Then its times beside the bound
   of the positions its mask needs (also logged: the full-cache bound and
   the bound of the tiles read), the plain version's time and one library
   call's; with every slot full, also at batch 16, 128 and 512 (one kv head:
   whole rows instead of head slices), S 768 and T 1, to show what bounds
   the kernel.
11. streamed — the split-S decode kernel against its plain version at the
   decode kernel's nine shapes, with a wholly masked first or middle
   split, and with splits of 16 and 32 positions, each also with NaN in
   the dead tiles; its times at batch 64 and 256 (bf16 and int8) logged as
   phase 3's, and at batch 64 also with splits of 64 and 128 positions;
   then ``serving/benchmark_decode_kernel.py``'s chain (plain, blocked,
   streamed) once, counting the streamed launches.
12. spec serve — the speculative main path: the same engine and 128
   requests with ``speculative_k=4`` and a draft table fitted to the
   model's own samples, bf16 and int8; every budget served, the chunk
   kernel launched n_layer times per verify round and the decode kernel
   never; then the plain engine on the same requests, for the record.
13. spec parity — on the 2-layer float32 model, greedy speculative serving
   gives the same tokens on the card (chunk kernel) and on the CPU (plain
   version), equal to the plain engine's; and masked greedy speculative
   generation equals ``generate_masked_tokens``.

14. pipeline — ``training/bench_pipeline.py``'s three protocols of
   ``bench.py`` on one built model and step at the training main path's
   width: synthetic windows on the card, then the real host pipeline under
   ``multi`` and ``binpack`` packing (chunking, packing, mmap sidecars,
   ``EpochPlan``, grouped microbatches, ``DevicePrefetcher`` from pinned
   memory), each 3 warm-up, 2 measured and 1 profiled group (the CLI
   measures 20 and profiles 3); logs
   tokens/s, pad fraction, ms per group, busy share and the host→device
   copies in the trace, and ``bench.py``'s one line. Each group's non-pad
   tokens counted on the card by the step must equal the host's count, and
   each flash kernel's launches, reset before each protocol, must equal
   16 x 10 per group.
15. trainer — the train CLI (``training/train_codon_lm.py``, in process
   through ``main(argv)``) at the same width on a packed synthetic corpus
   from ``build_packed_dataset`` (4 groups an epoch) for 2 epochs; a
   ``--resume`` with the same ``epochs`` must fail closed, one to epoch 3
   must succeed. Every artifact is checked, the losses finite and falling,
   3 rows in ``curves.csv``, the dK/dV and dQ launches 160 per group and
   the forward's 160 per group plus 10 per validation microbatch; the
   validation loss recomputed from ``last.npz`` (``load_checkpoint`` +
   ``params_from_jax``) must equal the trained model's.
16. spec trained — ``serving/benchmark_speculative.py`` once in bf16 (the
   JAX script's defaults, 2 serving repeats): a 4L4H d256 model trained on
   a Markov corpus by ``run_training``, then plain and speculative drains;
   logs acceptance, tokens per slot-round, both drains' tokens/s and the
   validation loss beside the chain's entropy rate; the chunk kernel must
   launch n_layer times per verify round. Then, after the counts are read,
   the decode and chunk kernels against their plain versions at the shapes
   this path ran them at (head width 64, which builds other template
   instances than phases 3 and 10's width 48; the cache positions each
   protocol reported), bf16 and int8 caches, random lengths and every slot
   full, with phase 3's and phase 10's tolerances.
17. lora d512 — ``training/benchmark_lora.py`` (the port of
   ``scripts/benchmark_lora.py --d512_efficiency``): 12L8H d512, block
   512, batch 8, fused QKV, bf16, flash; full fine-tuning against LoRA r8
   on the attention linears: trainable parameters (393,216 adapters),
   moment bytes, dense and adapter-only checkpoint bytes, ms per step and
   flash launches per step; re-attached adapters forward exactly.
18. finetune — the LoRA recipe (``configs/finetune_lora_r8_d512.yaml``,
   read, never edited; the phase writes derived YAMLs with its data
   paths, epochs, warmup and schedule length, and logs each override)
   through the CLIs on a packed corpus: pretrain a d512 base for 2 groups,
   ``--transfer_from`` it into LoRA for one epoch, resume a second, run
   the two epochs straight, merge with ``merge_lora``, and serve the
   merged checkpoint through ``ServingEngine`` (the decode kernel's
   launches reset before the drain and read after). Hard checks: every
   frozen weight of ``last.npz`` bit-equal to the base, only adapter
   moments in the optimizer state and as many as ``lora_param_count``,
   the resumed run bit-equal to the straight one, merged and unmerged
   float32 forwards within ``FINETUNE_MERGE_RTOL`` and their float32
   greedy tokens from ``ServingEngine`` equal, decode launches = layers x
   decode steps, flash launches per group and validation. Then the decode
   kernel against its plain version at the serve's shape (heads of 64).
19. remat contract — the primary training contract's model and step
   (``training/contracts.py``: 10L8H d384, B 4 x G 32 x T 512, bf16
   flash, ``use_checkpoint``) on synthetic windows, one group with remat
   and one without from one generator seed: equal loss, gradients within
   ``REMAT_GRAD_RTOL``, peak memory of each, flash forward launches 2 x 10
   x 32 against 10 x 32, ms per group over 3 more groups each.
20. int8 serve — weight-only int8 serving: phase 4's model with its block
   linears quantized by ``quantize_params`` (their bytes, dense against
   int8, checked and logged) drains the same 128 requests with a bf16 and
   an int8 cache, each beside the dense model's drain just before it;
   every budget in-vocabulary and the decode kernel launched n_layer times
   per step; one speculative drain (K 4) launches the chunk kernel n_layer
   times per round; a 2-layer float32 int8 model gives the same greedy
   tokens on the card and on the CPU; ``benchmark_serving --int8_weights``
   prints its closed-loop report and an open-loop (``--arrival_rate``) one.
21. generate — the run phase 15 wrote, loaded by ``load_codon_model``: every
   generator of ``generation/constrained.py`` from one seed (raw, also over
   a context longer than the block; constrained, with the termination bias
   when the run has the head; ReD; batch ReD under a budget; critic-guided
   with a numpy critic; synonymous to a 40-residue protein); each ``info``
   holds JAX's keys, the synonymous CDS translates exactly, codons stay
   within the hard cap and batch ReD within its budget. The decode
   kernel's launches equal n_layer x cached steps and the flash forward's
   n_layer x uncached forwards. Then ``sample``, ``query_model`` (next,
   generate, score) and ``serve_model --int8_weights`` (``/generate`` over
   localhost) on the run; and the decode kernel at ``CachedDecoder``'s
   shape (batch 1, a whole-block cache) against its plain version, timed
   beside its bound and SDPA.
22. score — ``context_ablation`` (windows 1, 2, 4 and full, which includes
   ``evaluate_perplexity``) on the run's validation split and
   ``score_mutations`` on a CDS longer than the block: every value finite,
   the flash forward launched n_layer times per microbatch and per scored
   window; the full-window and window-1 NLL on the card within
   ``SCORE_NLL_RTOL`` of the CPU's, both float32 from the same weights.
   Then the flash forward at inference (no dropout) against its plain
   version and timed: batch 64 x 512 at windows 1, 2, 4 and full, and
   batch 1 at 512 and an off-grid 77.
23. moe train — the MoE recipe (``configs/stage2.6_moe_4e_top2_d512_ep2.yaml``
   as is but data paths, epochs, run ids, warm-up 1 and a 6-step schedule,
   each override logged: 12L8H d512, 4 experts top-2 at capacity 1.25,
   router loss 0.01, B 8 x G 16, bf16 flash, dropout 0.1, label smoothing
   0.05) through the train CLI on a packed corpus: 2 epochs of 2 groups,
   then a resume to a third, beside a straight 3-epoch run. Hard checks:
   ``param_count`` 113,740,800 (38,126,592 dense), every loss and every
   router loss finite, ``router/w`` (12, 512, 4) in ``last.npz``, the
   resumed run bit-equal to the straight one, the flash launches 12 x 16 a
   group plus 12 a validation microbatch.
24. moe parity — a 2-layer float32 MoE at capacity 0.5 (about half the
   choices drop) takes one group step on the card and on the CPU:
   ``TRAIN_PARITY_TOL`` on loss, every gradient (router and experts) and
   the updated parameters; the dropped (token, rank) set of every layer
   equal, a differing choice allowed only on a near-tie (its probability
   margin, logged, within ``MOE_NEAR_TIE``).
25. moe serve — phase 23's run through ``load_codon_model``:
   ``ServingEngine`` drains phase 4's 128 requests (decode launches = 12
   x steps) and once speculatively with K 4 (chunk launches = 12 x
   rounds), then the bf16 chunk kernel at that drain's shapes (12 layers,
   64 slots, its cache, 8 kv heads of 64, T 5; ragged and full) is held to
   phase 10's bound and timed; ``quantize_params`` quarters the attention bytes and leaves
   the experts' and router's, and its drain's tokens/s is logged beside
   the dense one; ``evaluate_perplexity`` on the validation split (flash
   launches = 12 x microbatches) and the bf16 flash forward at its shape
   (B 8 x T 512, heads of 64, no dropout) held to phase 7's tolerance and
   timed beside its bound and SDPA, the float32 NLL on the card within
   ``SCORE_NLL_RTOL`` of the CPU's; at 2 layers in float32, greedy tokens
   equal on the card and the CPU with dense and int8 weights, and one
   request served alone equals its tokens from a full 64-slot drain.
26. moe throughput — ``training/benchmark_moe.py`` with 1 measured group:
   dense, top-1 and top-2 tokens/s, ms per group, peak memory and
   ``rel_to_dense``, each in a subprocess; then ``profile_step.py --moe``:
   a MoE group's device time split into router, dispatch, expert products,
   combine, flash and the rest, launches and the busy share.
27. embeddings — on phase 15's run and phase 23's: ``extract_embeddings``
   of 64 validation windows in the three pooling modes (finite; flash
   launches = n_layer x batches), float32 on the card within
   ``EMBED_F32_ATOL`` of the CPU, ``attention_maps`` at B 1 x T 512 (rows
   sum to 1, masked entries exactly 0); the bf16 flash forward at the MoE
   run's extraction shape (B 64 x T 512, heads of 64) held to phase 7's
   tolerance and timed; then the ``extract_embeddings`` and
   ``analyze_attention`` CLIs on the MoE run, their output printed.
28. noprop — ``train_noprop`` at 10L8H d384, block 512, on phase 15's
   corpus: 2 epochs and a resume to a third; every loss finite and one
   denoising loss per layer.
29. prepare — the demo corpus at ``benchmark_moe``'s defaults (800 genes,
   seed 1337) through ``prepare_dataset`` at blocks 256 and 512 (``multi``,
   genome-disjoint splits, ``skip_homology``), twice each: windows per
   split, seconds, every manifest validated, each block's dataset ids equal.
30. evaluate_test — the ``evaluate_test`` CLI on phase 23's MoE run and
   phase 15's run over the block-512 demo splits (``--train_npz``,
   ``--bootstrap 1000``, ``--context_ablation``): model NLL, every Markov
   baseline, the best simple model, each margin with its CI, seconds of
   each part; the flash forward launched n_layer times per microbatch (up
   to 64 rows, none padded) in each of its six passes; the float32 NLL on
   the card within ``SCORE_NLL_RTOL`` of the CPU's. Then the bf16 flash
   forward at every shape the passes launched it at (the 23 test windows:
   B 23 x T 512, full and windows 1, 2 and 4, heads of 64 on the MoE run
   and of 48 on phase 15's, the windows' own segment ids) against its
   plain version, timed. Runs trained on synthetic windows lose to the
   baselines on this corpus: the phase checks the machinery, not the
   verdict.
31. moe quality — ``python -m genomics_lm_torch.training.benchmark_moe
   --skip_throughput --converged_epochs 0 --epochs 3``: dense, top-1 and
   top-2 at the script's default widths (6L4H d256, block 256, B 16, lr
   1e-3) on the demo corpus, einsum attention; per variant val and test
   NLL, the delta to dense, whether it beats every Markov floor, parameters
   and training seconds. Cut: 3 of the script's 12 epochs, and the 30-epoch
   converged pass.
32. analysis — on phase 15's and phase 23's runs: ``run_full_analysis``,
   every dashboard data function (saliency, attention, embeddings with PCA,
   next codon, generation, browser, details) and ``generate_summary`` over
   the runs root. The saliency launches the flash forward, dQ and dK/dV
   once a layer, and its float32 result on the card is within
   ``SALIENCY_RTOL`` of the CPU's; the playground pages launch the decode
   kernel n_layer times a cached step, and their greedy next codon is the
   same on the card and the CPU. Then the float32 flash kernels at the
   saliency's shape (B 1, T 6, dropout 0, heads of 48 and of 64) and the
   decode kernel at the playground's (B 1 over a whole-block cache, each
   run's layers and heads) against their plain versions, timed.
33. demo run — the train CLI at the main path's config (10L8H d384, block
   512, bf16 flash) on the block-512 demo splits, B 8 x G 2 for 12 epochs:
   phase 15's run takes 8 steps on uniform random codons and still repeats
   its last codon, so it never stops; this run learns the corpus's codon
   usage, stops included, for phases 34-37; its validation loss must fall.
34. motifs — ``mine_motifs`` at its defaults (window 9, stride 1,
   ``--max_windows`` 256) on the demo run over the block-512 demo train
   split: one ``hidden_states`` pass over its rows (the flash forward
   launched n_layer times), the window embeddings pooled on the card, and
   KMeans when sklearn imports on the machine (otherwise one line says the
   clustering did not run, and the embedding checks still gate the exit
   code); the float32 embeddings on the card within ``CARD_CPU_RTOL`` of the
   CPU's; the flash forward at the pass's shape (every row at T 512, their
   segments, heads of 48), bf16 and float32, against its plain version,
   timed.
35. probes — ``fit_mlp`` on the card over those embeddings, labelled by each
   window's first amino acid, for ``PROBE_EPOCHS`` epochs: seconds per epoch
   and its metrics; float32 at dropout 0 from one init, card against CPU.
36. gen_prefix — ``eval_generation_prefix --preset quick --samples 1`` (cut
   from the preset's 2 for the smoke's time) on the demo run
   over the block-512 demo splits with ``--nll_controls``, ``--emit_replay``
   and the memorization audit: seconds of generation, scoring, controls and
   audit; the decode kernel launched n_layer times a cached step and the
   flash forward n_layer times a scored window; the replay loaded by
   ``data/replay.py``; ``token_nlls`` float32 on the card against the CPU;
   the flash forward at its B 1 windows and the decode kernel at the
   generations' cache against their plain versions, timed.
37. design — ``generative_design_loop`` at its defaults with
   ``--esm_fold_top 2 --fold_backend mock``: seconds, tokens spent, decode
   launches (n_layer a cached step), the termination rate; its candidates
   through ``audit_generated_sequences`` against the demo corpus's
   train-split records; a CPU run of the loop whose candidates are
   re-scored in float32 on the card and on the CPU.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's measured numbers; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import http.client
import importlib.util
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.evals import embeddings as emb_lib
from genomics_lm_torch.evals import mutations as mut
from genomics_lm_torch.evals import perplexity as ppl
from genomics_lm_torch.evals.analyze_attention import main as attention_cli
from genomics_lm_torch.evals.extract_embeddings import main as extract_cli
from genomics_lm_torch.evals.playground import load_codon_model, resolve_checkpoint
from genomics_lm_torch.generation import constrained as gc
from genomics_lm_torch.generation import decode as decode_mod
from genomics_lm_torch.generation.decode import (
    CachedDecoder,
    _decode_mask,
    generate_masked_tokens,
)
from genomics_lm_torch.generation.genetic_code import translate_codons_to_aa
from genomics_lm_torch.generation.query_model import main as query_cli
from genomics_lm_torch.generation.sample import main as sample_cli
from genomics_lm_torch.kernels.build import CSRC, build
from genomics_lm_torch.models import codon_gpt as codon_gpt_mod
from genomics_lm_torch.models import noprop as noprop_lib
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.codon_gpt import forward as model_forward
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.ops import decode_attention as da
from genomics_lm_torch.ops import flash_attention as fa
from genomics_lm_torch.ops.masks import segment_ids_from_tokens as segment_ids
from genomics_lm_torch.ops.masks import structure_mask
from genomics_lm_torch.ops.quant import quantize_params
from genomics_lm_torch.serving import benchmark_decode_kernel as bench_decode
from genomics_lm_torch.serving import benchmark_serving as bench_serving
from genomics_lm_torch.serving import benchmark_speculative as bench_spec
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.serving.profile_drain import (
    ENGINE,
    MAIN,
    REQUESTS,
    SPECULATIVE_K,
    build_requests,
    fit_draft_table,
)
from genomics_lm_torch.serving.serve_model import build_server as serve_build
from genomics_lm_torch.serving.serve_model import parser as serve_parser
from genomics_lm_torch.serving.server import InferenceServer
from genomics_lm_torch.serving.speculative import (
    fit_bigram_table,
    generate_tokens_speculative,
    restrict_table,
)
from genomics_lm_torch.training import bench_pipeline as bench_pipe
from genomics_lm_torch.training import benchmark_moe as bench_moe
from genomics_lm_torch.training import benchmark_lora as bench_lora
from genomics_lm_torch.training import contracts
from genomics_lm_torch.training import lora as lora_lib
from genomics_lm_torch.training import profile_step as train_main
from genomics_lm_torch.training.checkpoints import load_checkpoint, load_checkpoint_meta
from genomics_lm_torch.data.datasets import EpochPlan, PackedDataset
from genomics_lm_torch.models.biophysics import ShapeEncoder, shape_lookup_table
from genomics_lm_torch.tokenizers.codon import STOP_IDS, write_itos
from genomics_lm_torch.training.lifecycle import RunLifecycleError
from genomics_lm_torch.training.merge_lora import main as merge_cli
from genomics_lm_torch.training.train_codon_lm import main as train_cli
from genomics_lm_torch.training.train_noprop import main as noprop_cli
from genomics_lm_torch.training.optim import build_optimizer
from genomics_lm_torch.training.train_step import LossConfig, make_eval_step, make_train_step
from genomics_lm_torch.utils.timing import card_peaks, decode_bound_ms, median_ms
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax

KERNEL_SOURCES = ["decode_attention", "flash_attention", "decode_attention_chunk",
                  "decode_attention_streamed"]

KERNEL_ATOL = 1e-3
KERNEL_ATOL_REASON = (
    "both sides read the same rounded operands (bf16, f32 or int8 with f32 "
    "scales) and accumulate in f32, so only the order of the sums differs "
    "(~1e-6 on outputs of order 1); an indexing or masking fault moves an "
    "output by order 1")

# The bf16-query chunk kernel (tensor cores): a bound per output element.
CHUNK_BF16_TOL = 2.0**-7
CHUNK_BF16_TOL_REASON = (
    "the kernel rounds each probability to bf16 (unit roundoff 2^-8) before P.V, where "
    "the plain version keeps it float32; every other operand is the same rounded value "
    "on both sides and every sum is float32. So output (r, d) moves by at most 2^-8 "
    "times sum_j p_j |v_j| (v_j times its scale in int8, p normalized), the plain "
    "version run on |V|; the bound allows twice that plus 1e-5 for the order of the "
    "float32 sums. Checked to catch a skipped live tile and another slot's mask rows "
    "(their errors over the bound are logged as fault_ratios and must exceed 1)")

# Published float32 rate of one H100 SXM outside the tensor cores (the float32
# flash kernels are SIMT), the operations bound of a float32 case.
F32_PEAK_OPS = 67e12

# Flash kernels: error over max(1, max |plain|) of each output.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
FLASH_TOL_REASON = (
    "kernel and plain version read the same rounded operands and the same Philox "
    "keep bits and accumulate in float32. float32 (SIMT kernels): only the order "
    "of the sums differs (~1e-6 relative). bf16: the tensor-core kernels round "
    "P and dS to bf16 before the second product, as FlashAttention-2 does (the "
    "plain version keeps them float32), at most 2^-8 relative per term, and "
    "outputs round to bf16 (up to 2^-8 relative); "
    "together well under 2^-6 of the largest entry. A fault of indexing, "
    "masking, tile skipping or keep bits moves entries by much more: the "
    "float32 case at 1e-4 sees one flipped keep bit, and so does the bf16 case "
    "with a segment every 4 tokens at dropout 0.5, where each row sees at most "
    "4 keys")
# Card-vs-CPU step: both sides run float32 (TF32 off) and differ only in the
# order of their sums, so loss and gradients are held tightly. Adam's first
# step moves an element by lr * g / (|g| + eps) with lr = 3e-4 whatever the
# gradient's size. Where |g| is far above eps the step is lr * sign(g) on both
# sides, so those parameters are held to param_atol. Where the gradient is
# near rounding level (the key bias, whose gradient is zero in exact
# arithmetic since softmax ignores a score shift shared by all keys, and the
# smallest entries of other leaves) the step follows the rounding noise and
# may take any value up to lr; parameters whose CPU gradient is below
# noise_grad_share of the model's largest are held to half a step, which a
# missing, doubled or sign-flipped update still exceeds. The log names the
# leaf that sets each error.
TRAIN_PARITY_TOL = dict(loss_rtol=1e-5, grad_rtol=1e-4, param_atol=3e-5,
                        noise_grad_share=1e-3, noise_param_atol=1.5e-4)
# The same step with every objective, LoRA under lora_only, Adafactor and an
# active grad_clip. Adafactor's first update of an unfactored leaf is
# lr * g / |g| (its eps is 1e-30, Adam's 1e-8 shrinks the step of a tiny
# gradient): a parameter whose gradient is rounding noise may take +lr on one
# side and -lr on the other, so those are held to two steps (6e-4); the
# parameters with a real gradient keep param_atol.
OBJECTIVES_GRAD_CLIP = 0.05
TRAIN_PARITY_OBJECTIVES_TOL = dict(TRAIN_PARITY_TOL, noise_param_atol=6e-4)

# last.npz against the run: the reloaded model runs the same bf16 eval path on
# the same float32 weights and batches, so its validation loss repeats the
# recorded one up to the order of float32 sums (the flash forward and GEMMs
# are deterministic); a wrong leaf moves it by far more
TRAINER_RELOAD_RTOL = 1e-5


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


# --- phase 2: build ------------------------------------------------------------


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    for name, lib in paths.items():
        report = lib.with_name(lib.name + ".log")
        text = report.read_text() if report.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
        log("build", kernel=name, source=str((CSRC / f"{name}.cu").name),
            seconds=round(seconds, 2), instantiations=len(regs),
            max_registers=max(regs, default=None),
            spill_store_bytes=sum(spills))
        if name in ("flash_attention", "decode_attention_chunk"):
            log("build_mma", source=name, **kernel_report(text))
        else:  # the single-token tile kernels of a bf16 query
            log("build_tiles", source=name, **kernel_report(text))


DTYPE_NAMES = {"0": "f32", "1": "bf16", "2": "f16", "3": "int8"}


def _kernel_name(symbol: str) -> str | None:
    """``kernel<template arguments>`` of a tensor-core kernel's mangled name,
    or of a bf16-query instantiation of the single-token tile kernel."""
    flash = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_mma_kernel)ILi(\d+)E", symbol)
    if flash:
        return f"{flash.group(1)}<{flash.group(2)}>"
    chunk = re.search(r"(decode_attention_chunk_mma_kernel)ILi(\d+)ELi(\d+)ELb([01])E", symbol)
    if chunk:
        cache = "int8" if chunk.group(4) == "1" else "bf16"
        return f"{chunk.group(1)}<{chunk.group(2)},{chunk.group(3)},{cache}>"
    tile = re.search(r"(decode_tile_kernel)ILi(\d)ELi(\d)ELi(\d)ELb([01])E", symbol)
    if tile and tile.group(2) == "1":
        reads = "16B" if tile.group(5) == "1" else "scalar"
        return (f"{tile.group(1)}<{DTYPE_NAMES[tile.group(2)]},{DTYPE_NAMES[tile.group(3)]},"
                f"G{tile.group(4)},{reads}>")
    return None


def kernel_report(text: str) -> dict:
    """{kernel<...>: {registers, spill_store_bytes}} of the bf16 tensor-core
    kernels (flash forward, dQ, dK/dV; verify chunk) and of the bf16-query
    single-token tile kernels, read from the ``-Xptxas -v`` report."""
    out, current = {}, None
    for line in text.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?"
                          r"(?: for|$)", line)
        if entry:
            current = _kernel_name(entry.group(1))
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            out.setdefault(current, {})["spill_store_bytes"] = int(spill.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out.setdefault(current, {})["registers"] = int(used.group(1))
    return out


# --- phase 3: the kernel against its plain version ------------------------------


def make_case(gen, L, B, S, Hkv, G, D, cache_dtype, q_dtype, lengths="random"):
    """Random packed caches and query on the card, and a (B, S) mask:
    ``lengths`` "random" gives ragged same-segment rows (row 0 with a segment
    boundary), "serve" the serving drain's rows (``serve_mask``), "full"
    every position live, an int that many leading positions of each row."""
    dev = "cuda"
    P = Hkv * D
    ks = vs = None
    if cache_dtype == torch.int8:
        k = torch.randint(-127, 128, (L, B, S, P), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (L, B, S, P), generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.02
        vs = torch.rand((L, B, Hkv, S), generator=gen, device=dev) * 0.02
    else:
        k = torch.randn((L, B, S, P), generator=gen, device=dev).to(cache_dtype)
        v = torch.randn((L, B, S, P), generator=gen, device=dev).to(cache_dtype)
    q = torch.randn((B, Hkv * G, D), generator=gen, device=dev).to(q_dtype)
    if lengths == "serve":
        return q, k, v, serve_mask(B, S), ks, vs
    if lengths == "full":
        return q, k, v, torch.zeros((B, S), device=dev), ks, vs
    if isinstance(lengths, int):  # the first ``lengths`` positions of every row live
        live = torch.arange(S, device=dev)[None, :] < lengths
        return q, k, v, torch.zeros((B, S), device=dev).masked_fill_(~live, da.NEG_INF), ks, vs
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    pos = torch.arange(S, device=dev)[None, :]
    valid = pos < lengths[:, None]
    valid[0, : S // 3] = False  # a segment boundary in row 0 ...
    valid[0, S // 2] = True     # ... with the self slot still attendable
    mask = torch.zeros((B, S), device=dev).masked_fill_(~valid, da.NEG_INF)
    return q, k, v, mask, ks, vs


def serve_mask(B, S):
    """The (B, S) mask of one decode step of the serving drain: the first
    ``B`` requests of ``profile_drain.build_requests`` (seed 0), each slot at
    a length drawn uniformly from prompt .. prompt + budget, one segment,
    built by ``_decode_mask`` (the code the engine runs)."""
    rng = np.random.default_rng(0)
    reqs = build_requests(rng, B)
    lengths = torch.tensor([len(p) + int(rng.integers(0, b + 1)) for p, b, _ in reqs],
                           device="cuda")
    seg = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    return _decode_mask(seg, seg[:, 0], lengths[:, None], lengths.clamp_max(S - 1)[:, None],
                        MAIN["sep_id"])


def poison_dead_tiles(k, v, ks, vs, mask):
    """Copies of the caches with every dead tile of the (B, S) mask
    (``decode_live_tiles``) set to NaN: K and V, or an int8 cache's k and v
    scales. A kernel that reads such a tile carries NaN into its output
    (probability 0 times NaN)."""
    dead = ~da.decode_live_tiles(mask).repeat_interleave(da.CHUNK_TILE, 1)[:, :mask.shape[1]]
    if ks is None:
        k, v = k.clone(), v.clone()
        k[:, dead] = float("nan")
        v[:, dead] = float("nan")
    else:
        sd = dead[:, None, :].expand_as(ks[0])
        ks, vs = ks.clone(), vs.clone()
        ks[:, sd] = float("nan")
        vs[:, sd] = float("nan")
    return k, v, ks, vs


def max_err(got, want) -> float:
    """max |got - want|, infinite where ``got`` is not finite."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max())


def decode_bounds(mask, B, S, Hkv, G, D, esize, q_esize, quant, peak_bw, peak_ops, T=1):
    """For a (B, T, S) mask: the tiles a tile-skipping kernel reads
    (``chunk_live_tiles``) of the total, the positions the mask needs (live
    in some row, summed over the slots), the positions of the live tiles,
    and the bounds of those two and of the full cache (the first is the
    kernels line's bound)."""
    live = da.chunk_live_tiles(mask)
    needed = int((mask > 0.5 * da.NEG_INF).any(dim=1).sum())
    sizes = (S - torch.arange(live.shape[1], device=live.device) * da.CHUNK_TILE
             ).clamp_max(da.CHUNK_TILE)
    read = int((live * sizes).sum())
    bound = {key: decode_bound_ms(B, S, Hkv, G, D, esize, q_esize, quant, peak_bw, peak_ops,
                                  T=T, positions=positions)
             for key, positions in (("needed", needed), ("full", None), ("read", read))}
    tiles = dict(tiles_read=int(live.sum()) * Hkv, tiles_total=live.numel() * Hkv)
    return tiles, needed, read, bound


def time_decode_case(name, q, k, v, mask, ks, vs, Hkv, G, fn, peak_bw, peak_ops, err,
                     nan_err, phase, **extra):
    """Times one single-token kernel ``fn`` over all L layers beside its plain
    version and SDPA (float caches); logs the tiles it reads and the three
    bounds; returns the kernels line's numbers."""
    L, B, S, _ = k.shape
    D = q.shape[-1]
    quant = ks is not None
    plain = (da.decode_attention_streamed_reference if fn is da.decode_attention_streamed
             else da.decode_attention_reference)

    def sweep(f):  # one timed run sweeps all L layers, so every launch reads its layer cold
        return lambda: [f(q, k, v, mask, layer, ks, vs, kv_heads=Hkv) for layer in range(L)]

    kernel_ms = median_ms(sweep(fn)) / L
    plain_ms = median_ms(sweep(plain)) / L
    library_ms = None
    if not quant:
        q4, am = q[:, :, None, :], mask[:, None, None, :].to(q.dtype)

        def sweep_library():
            for layer in range(L):
                kl = k[layer].view(B, S, Hkv, D).transpose(1, 2)
                vl = v[layer].view(B, S, Hkv, D).transpose(1, 2)
                torch.nn.functional.scaled_dot_product_attention(
                    q4, kl, vl, attn_mask=am, enable_gqa=True)

        library_ms = median_ms(sweep_library) / L
    tiles, needed, read, bound = decode_bounds(mask[:, None], B, S, Hkv, G, D, k.element_size(),
                                               q.element_size(), quant, peak_bw, peak_ops)
    b_ms, b_by, nbytes = bound["needed"]
    timed = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=library_ms, max_abs_err=err)
    log(phase, case=name, bytes=nbytes, positions_needed=needed, positions_read=read, **tiles,
        **timed, full_bound_ms=bound["full"][0], live_bound_ms=bound["read"][0],
        nan_dead_tiles_err=nan_err, **extra,
        achieved_gb_per_s=nbytes / (kernel_ms * 1e-3) / 1e9, roofline_share=b_ms / kernel_ms,
        full_roofline_share=bound["full"][0] / kernel_ms,
        live_roofline_share=bound["read"][0] / kernel_ms)
    return timed


def check_decode_case(gen, phase, name, L, B, S, Hkv, G, D, cdt, qdt, lengths):
    """The decode kernel against its plain version on every layer of one
    case (``make_case``), and again with NaN in the dead tiles; logs the
    case under ``phase`` and raises if either error passes ``KERNEL_ATOL``.
    Returns the case's tensors and the two errors."""
    q, k, v, mask, ks, vs = make_case(gen, L, B, S, Hkv, G, D, cdt, qdt, lengths)
    pk, pv, pks, pvs = poison_dead_tiles(k, v, ks, vs, mask)
    err = nan_err = 0.0
    for layer in range(L):
        got = da.decode_attention(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)
        want = da.decode_attention_reference(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)
        got_poisoned = da.decode_attention(q, pk, pv, mask, layer, pks, pvs, kv_heads=Hkv)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        err = max(err, max_err(got, want))
        nan_err = max(nan_err, max_err(got_poisoned, want))
    del pk, pv, pks, pvs
    live = da.decode_live_tiles(mask)
    log(phase, case=name, shape=dict(L=L, B=B, S=S, Hkv=Hkv, Hq=Hkv * G, D=D),
        cache=str(cdt).removeprefix("torch."), lengths=lengths,
        tiles_read=int(live.sum()) * Hkv, tiles_total=live.numel() * Hkv,
        max_abs_err=err, nan_dead_tiles_err=nan_err, tol=KERNEL_ATOL,
        tol_reason=KERNEL_ATOL_REASON)
    if err > KERNEL_ATOL or nan_err > KERNEL_ATOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({err}; with NaN in the dead tiles {nan_err}; "
                             f"tolerance {KERNEL_ATOL})")
    return q, k, v, mask, ks, vs, err, nan_err


def phase_kernel(peak_bw, peak_ops) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, L, B, S, Hkv, G, D, cache dtype, q dtype, lengths, timed
        ("main_bf16", 10, 64, 256, 8, 1, 48, bf16, bf16, "random", True),
        ("main_int8", 10, 64, 256, 8, 1, 48, torch.int8, bf16, "random", True),
        ("gqa4_bf16", 4, 64, 256, 2, 4, 48, bf16, bf16, "random", False),
        ("gqa4_int8", 4, 64, 256, 2, 4, 48, torch.int8, bf16, "random", False),
        ("g8_d64_bf16", 2, 16, 512, 1, 8, 64, bf16, bf16, "random", False),
        ("offgrid_f32_d16", 2, 5, 130, 4, 2, 16, f32, f32, "random", False),
        ("offgrid_bf16", 2, 5, 130, 8, 1, 48, bf16, bf16, "random", False),
        ("scalar_loads_d20", 2, 3, 77, 2, 2, 20, bf16, bf16, "random", False),
        ("int8_f32_query", 2, 5, 130, 2, 2, 48, torch.int8, f32, "random", False),
        # the serving drain's lengths, and every slot full (no dead tile)
        ("serve_bf16", 10, 64, 256, 8, 1, 48, bf16, bf16, "serve", True),
        ("serve_int8", 10, 64, 256, 8, 1, 48, torch.int8, bf16, "serve", True),
        ("full_bf16", 10, 64, 256, 8, 1, 48, bf16, bf16, "full", True),
    ]
    timed = {}
    for name, L, B, S, Hkv, G, D, cdt, qdt, lengths, is_timed in cases:
        q, k, v, mask, ks, vs, err, nan_err = check_decode_case(
            gen, "kernel", name, L, B, S, Hkv, G, D, cdt, qdt, lengths)
        if is_timed:
            host_paced_ms = median_ms(
                lambda: [da.decode_attention(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)
                         for layer in range(L)], queued=False) / L
            timed[name] = time_decode_case(name, q, k, v, mask, ks, vs, Hkv, G,
                                           da.decode_attention, peak_bw, peak_ops, err,
                                           nan_err, "kernel_time", host_paced_ms=host_paced_ms)
    return timed


# --- phase 4: the main serving path ---------------------------------------------


def drain(model, cfg, reqs, kv_quant, seed=0, **engine_kw):
    """Serve ``reqs`` to completion; returns (results, seconds, engine)."""
    eng = ServingEngine(model, cfg, **ENGINE, kv_quant=kv_quant, seed=seed, device="cuda",
                        **engine_kw)
    rids = [eng.submit(p, b, temperature=t) for p, b, t in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for rid, (_, budget, _) in zip(rids, reqs):
        toks = results[rid].tokens
        if len(toks) != budget or results[rid].finish_reason != "length":
            raise AssertionError(f"request {rid}: {len(toks)} tokens of {budget}, "
                                 f"finish {results[rid].finish_reason!r}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: token outside the vocabulary")
    return results, seconds, eng


def phase_serve(card: str) -> dict:
    cfg = CodonGPTConfig(**MAIN)
    torch.manual_seed(0)
    model = CodonGPT(cfg).to("cuda").eval()
    rng = np.random.default_rng(0)
    drain(model, cfg, build_requests(rng, 8), kv_quant=False)  # warm-up: cuBLAS, allocator
    reqs = build_requests(rng, REQUESTS)
    counts, tokens_per_s = {}, {}
    for kv_quant in (False, True):
        torch.cuda.reset_peak_memory_stats()
        da.decode_attention.launches = 0  # the count of the main path's run only
        results, seconds, eng = drain(model, cfg, reqs, kv_quant)
        launches = da.decode_attention.launches
        steps = eng.stats()["decode_steps"]
        if launches == 0 or launches != cfg.n_layer * steps:
            raise AssertionError(f"kernel launches {launches} != n_layer x decode steps "
                                 f"({cfg.n_layer} x {steps})")
        delivered = sum(len(r.tokens) for r in results.values())
        counts[kv_quant] = launches
        tokens_per_s[kv_quant] = delivered / seconds
        log("serve", model="10L8H d384 bf16 fused_qkv", kv_quant=kv_quant,
            requests=len(reqs), slots=ENGINE["slots"],
            steps_per_sync=ENGINE["steps_per_sync"],
            delivered_tokens=delivered, seconds=seconds,
            delivered_tokens_per_s=delivered / seconds, decode_steps=steps,
            kernel_launches=launches,
            ms_per_decode_step=seconds * 1e3 / steps,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
    return {"model": model, "cfg": cfg, "launches": counts[False],
            "launches_int8": counts[True], "tokens_per_s": tokens_per_s}


# --- phase 5: the card against the CPU ------------------------------------------


def phase_parity() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CodonGPTConfig(**dict(MAIN, n_layer=2, block_size=256, compute_dtype="float32"))
    torch.manual_seed(1)
    cpu_model = CodonGPT(cfg).eval()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(1)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], 24) for n in (9, 23, 40, 17)]
    reqs[1][0][7] = 3  # a <SEP> inside one prompt

    def tokens(model, device):
        eng = ServingEngine(model, cfg, slots=4, max_seq_len=128, steps_per_sync=8,
                            device=device)
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    before = da.decode_attention.launches
    on_card, on_cpu = tokens(gpu_model, "cuda"), tokens(cpu_model, "cpu")
    launched = da.decode_attention.launches - before
    same = on_card == on_cpu
    log("parity", model="2L8H d384 f32", prompts=len(reqs), identical_tokens=same,
        kernel_launches=launched)
    if not same or launched == 0:
        raise AssertionError("greedy tokens differ between the card and the CPU")


# --- phase 6: HTTP ---------------------------------------------------------------


def phase_http(model, cfg) -> None:
    eng = ServingEngine(model, cfg, **ENGINE, device="cuda")
    server = InferenceServer(eng, host="127.0.0.1", port=0)
    server.start()
    try:
        def call(method, path, body=None):
            conn = http.client.HTTPConnection(*server.address, timeout=120)
            try:
                conn.request(method, path, None if body is None else json.dumps(body),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, resp.read()
            finally:
                conn.close()

        prompt = [1] + list(range(10, 40))
        replies = []
        for body in ({"prompt": prompt, "max_new_tokens": 20},
                     {"dna": "ATGGCTAGCAAAGGAGAAGAACTT", "max_new_tokens": 12,
                      "temperature": 1.0},
                     {"prompt": prompt, "max_new_tokens": 20, "stream": True}):
            status, raw = call("POST", "/generate", body)
            if status != 200:
                raise AssertionError(f"/generate answered {status}: {raw[:200]!r}")
            if body.get("stream"):
                events = [json.loads(x) for x in raw.decode().splitlines() if x.strip()]
                toks = sum((e["tokens"] for e in events), [])
                reason = events[-1]["finish_reason"]
            else:
                reply = json.loads(raw)
                toks, reason = reply["tokens"], reply["finish_reason"]
            if len(toks) != body["max_new_tokens"] or reason != "length":
                raise AssertionError(f"/generate gave {len(toks)} tokens, finish {reason!r}")
            replies.append(toks)
        if replies[0] != replies[2]:
            raise AssertionError("streamed greedy reply differs from the whole reply")
        status, raw = call("GET", "/stats")
        stats = json.loads(raw)
        if status != 200 or stats["completed"] != 3:
            raise AssertionError(f"/stats answered {status}: {stats}")
        log("http", requests=3, streamed=1, stats_completed=stats["completed"])
    finally:
        server.stop()


# --- phase 7: the flash kernels against their plain versions ---------------------


def flash_case(gen, B, Hq, Hkv, T, S, D, dtype, window, rate, causal=True, segs=97):
    """Random q, k, v, segment ids, seed, config. ``segs``: a <SEP> every
    ``segs``-th token (running count, as the main path's batches), or
    "random": ids drawn from {0..3}, not monotone."""
    dev = "cuda"
    q = torch.randn((B, Hq, T, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    if segs == "random":
        seg = torch.randint(0, 4, (B, S), generator=gen, device=dev, dtype=torch.int32)
    else:
        seps = (torch.arange(S, device=dev) % segs == 0).to(torch.int32)
        seg = torch.cumsum(seps[None, :].expand(B, S), dim=-1, dtype=torch.int32).contiguous()
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    return q, k, v, seg, seed, fa.FlashCfg(causal, window, rate)


def flash_bounds(q, k, seg, cfg, peak_bw, peak_ops):
    """Least time of each kernel at these inputs: each input read once and
    each output written once over the memory rate, or the operations (a
    multiply and an add each) of the attended (query, key) pairs over the
    bf16 peak, whichever is larger. Per pair: q.k and p.v (4 D operations)
    forward; q.k, dO.v and dS.k (6 D) for dQ; q.k, dO.v, P^T.dO and dS^T.q
    (8 D) for dK/dV."""
    B, Hq, T, D = q.shape
    S = k.shape[2]
    pairs = int(structure_mask(T, S, causal=cfg.causal, window=cfg.window, segment_ids=seg,
                               device=q.device).sum()) * Hq
    e = q.element_size()
    qbytes, kvbytes = q.numel() * e, k.numel() * e
    rows, ids = B * Hq * T * 4, B * S * 4
    work = {  # name: (bytes, operations)
        "fwd": (2 * qbytes + 2 * kvbytes + rows + ids, 4 * D * pairs),
        "dq": (3 * qbytes + 2 * kvbytes + 2 * rows + ids, 6 * D * pairs),
        "dkv": (2 * qbytes + 4 * kvbytes + 2 * rows + ids, 8 * D * pairs),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / peak_bw * 1e3, ops / peak_ops * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, operations=ops)
    return out, pairs


def phase_flash(peak_bw, peak_ops) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    width = train_main.MAIN_TRAIN
    B, H, T, D = train_main.B, width["n_head"], train_main.T, width["n_embd"] // width["n_head"]
    cases = [
        # name, B, Hq, Hkv, T, S, D, dtype, window, dropout, segments, timed
        ("main_bf16", B, H, H, T, T, D, bf16, None, 0.0, 97, False),
        ("main_bf16_dropout", B, H, H, T, T, D, bf16, None, 0.1, 97, True),
        ("gqa_bf16", B, H, 2, T, T, D, bf16, None, 0.1, 97, False),
        ("window64_bf16", B, H, H, T, T, D, bf16, 64, 0.1, 97, False),
        ("suffix_bf16", B, H, H, 128, T, D, bf16, None, 0.1, 97, False),
        ("offgrid_bf16", B, H, H, 130, 130, D, bf16, None, 0.1, 97, False),
        ("f32_gqa_window_d20", 2, 4, 2, 200, 333, 20, f32, 50, 0.1, 97, False),
        ("f32_noncausal_d64", 2, 4, 4, 150, 150, 64, f32, None, 0.1, 97, False),
        # the tensor-core kernels' failure modes: a wrong keep bit or a wrongly
        # skipped tile (only diagonal tiles live; <= 4 keys a row), ids that
        # skip no tile, padded head widths, GQA 4:1 with a window off the grid
        ("seg4_dropout50_bf16", 2, H, H, T, T, D, bf16, None, 0.5, 4, False),
        ("random_ids_bf16", 2, H, H, T, T, D, bf16, None, 0.1, "random", False),
        ("d20_bf16", 2, 4, 4, 200, 200, 20, bf16, None, 0.1, 97, False),
        ("d64_bf16", 2, 4, 4, 200, 200, 64, bf16, None, 0.1, 97, False),
        ("d128_bf16", 2, 4, 4, 200, 200, 128, bf16, None, 0.1, 97, False),
        ("gqa4_window50_bf16", 2, 8, 2, 130, 333, D, bf16, 50, 0.1, 97, False),
        ("noncausal_bf16", 2, 4, 4, 150, 150, D, bf16, None, 0.1, 97, False),
        # the LoRA fine-tuning path's width: 12L8H d512, heads of 64 at T 512
        ("d512_main_bf16", B, 8, 8, T, T, 64, bf16, None, 0.1, 97, True),
        ("d512_gqa_bf16", B, 8, 2, T, T, 64, bf16, None, 0.1, 97, False),
    ]
    timed: dict[str, dict] = {}
    for name, b, hq, hkv, t, s_len, d, dtype, window, rate, segs, is_timed in cases:
        row = check_flash_case(gen, "flash", name, b, hq, hkv, t, s_len, d, dtype, window,
                               rate, segs, is_timed, peak_bw, peak_ops)
        if row is not None:
            timed[name] = row
    return timed


def check_flash_case(gen, phase, name, b, hq, hkv, t, s_len, d, dtype, window, rate, segs,
                     is_timed, peak_bw, peak_ops) -> dict | None:
    """One flash case: the forward, dQ and dK/dV kernels (through the
    autograd Function, a fixed random cotangent) against their plain
    versions within ``FLASH_TOL``; when ``is_timed``, then each kernel's
    time beside its bound (bf16 operations over the bf16 peak, float32 over
    the float32 SIMT peak), its plain version's and SDPA's, as
    ``{"fwd"|"dq"|"dkv": {...}}``."""
    bf16 = torch.bfloat16
    causal = "noncausal" not in name
    q, k, v, seg, seed, cfg = flash_case(gen, b, hq, hkv, t, s_len, d, dtype, window, rate,
                                         causal, segs)
    live = fa.flash_live_tiles(seg, t, s_len, causal, window)
    band = fa.flash_live_tiles(None, t, s_len, causal, window)
    tiles = dict(band_tiles=int(band.sum()) * b * hq)
    # the bf16 kernels skip dead tiles; the float32 kernels visit the band
    tiles["tiles_visited"] = int(live.sum()) * hq if dtype == bf16 else tiles["band_tiles"]
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=seg, attention_window=window,
                             dropout_rate=rate, seed=seed, causal=causal)
    cot = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    grads = torch.autograd.grad(out, (qg, kg, vg), cot)
    _, lse = fa.flash_fwd(q, k, v, seg, seed, cfg)
    want_out, want_lse = fa.flash_forward_reference(q, k, v, seg, seed, cfg)
    delta = (cot.float() * out.detach().float()).sum(dim=-1)
    want = [fa.flash_bwd_dq_reference(q, k, v, seg, seed, cot, want_lse, delta, cfg),
            *fa.flash_bwd_dkv_reference(q, k, v, seg, seed, cot, want_lse, delta, cfg)]
    torch.cuda.synchronize()
    errs, abs_errs = {}, {}
    for key, got, ref in zip(("out", "lse", "dq", "dk", "dv"),
                             (out.detach(), lse, *grads), (want_out, want_lse, *want)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash {name}: non-finite {key}")
        abs_errs[key] = float((got.float() - ref.float()).abs().max())
        errs[key] = abs_errs[key] / max(1.0, float(ref.float().abs().max()))
    tol = FLASH_TOL[dtype]
    log(phase, case=name, shape=dict(B=b, Hq=hq, Hkv=hkv, T=t, S=s_len, D=d),
        dtype=str(dtype).removeprefix("torch."), causal=causal, window=window,
        dropout=rate, segments=segs, **tiles,
        rel_err=errs, max_abs_err=abs_errs, tol=tol, tol_reason=FLASH_TOL_REASON)
    if max(errs.values()) > tol:
        raise AssertionError(f"flash {name}: kernel disagrees with its plain version "
                             f"({errs} > {tol})")
    if not is_timed:
        return None
    bounds, pairs = flash_bounds(q, k, seg, cfg, peak_bw,
                                 peak_ops if dtype == bf16 else F32_PEAK_OPS)
    dout = cot.contiguous()
    kernel = {
        "fwd": lambda: fa.flash_fwd(q, k, v, seg, seed, cfg),
        "dq": lambda: fa.flash_bwd_dq(q, k, v, seg, seed, dout, lse, delta, cfg),
        "dkv": lambda: fa.flash_bwd_dkv(q, k, v, seg, seed, dout, lse, delta, cfg),
    }
    plain = {
        "fwd": lambda: fa.flash_forward_reference(q, k, v, seg, seed, cfg),
        "dq": lambda: fa.flash_bwd_dq_reference(q, k, v, seg, seed, dout, lse, delta, cfg),
        "dkv": lambda: fa.flash_bwd_dkv_reference(q, k, v, seg, seed, dout, lse, delta,
                                                  cfg),
    }
    # the yardstick: SDPA with the dense boolean mask and the same dropout
    # rate (its own random stream); its backward computes dQ, dK and dV at
    # once, so that one time stands beside both backward kernels
    dense = structure_mask(t, s_len, causal=causal, window=window, segment_ids=seg,
                           device=q.device)
    ql, kl, vl = (x.clone().requires_grad_() for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=dense, dropout_p=rate)

    lib_out = sdpa()
    library = {"fwd": median_ms(sdpa, runs=15),
               "bwd": median_ms(lambda: torch.autograd.grad(
                   lib_out, (ql, kl, vl), dout, retain_graph=True), runs=15)}
    err_of = {"fwd": max(abs_errs["out"], abs_errs["lse"]), "dq": abs_errs["dq"],
              "dkv": max(abs_errs["dk"], abs_errs["dv"])}
    timed = {}
    for key in ("fwd", "dq", "dkv"):
        ms = median_ms(kernel[key], runs=15)
        timed[key] = dict(ms=ms, plain_ms=median_ms(plain[key], runs=5),
                          bound_ms=bounds[key]["bound_ms"], bound_by=bounds[key]["bound_by"],
                          library_ms=library["fwd" if key == "fwd" else "bwd"],
                          max_abs_err=err_of[key])
        log(phase + "_time", kernel=key, case=name, dtype=str(dtype).removeprefix("torch."),
            attended_pairs=pairs, bytes=bounds[key]["bytes"],
            operations=bounds[key]["operations"], **timed[key], **tiles,
            roofline_share=bounds[key]["bound_ms"] / ms)
    return timed


# --- phase 8: the training main path ----------------------------------------------

FLASH_WRAPPERS = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)


def phase_train(card: str) -> dict:
    cfg, model, bundle, step = train_main.build_main("cuda")
    gen = torch.Generator(device="cuda").manual_seed(train_main.SEED)
    batches = [train_main.make_batch(s, "cuda") for s in range(train_main.BATCHES)]
    nonpad = int((batches[0]["y"] != 0).sum())
    warmup, measured = 3, 10
    train_main.run_groups(model, bundle, step, batches, gen, warmup)
    torch.cuda.reset_peak_memory_stats()
    for w in FLASH_WRAPPERS:
        w.launches = 0  # the count of the main path's measured run only
    seconds, metrics = train_main.run_groups(model, bundle, step, batches, gen, measured)
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    G = train_main.G
    losses = [float(m["total_loss_sum"]) / max(1, int(m["committed_microbatches"]))
              for m in metrics]
    applied = [bool(m["applied"]) for m in metrics]
    log("train", model="10L8H d384 bf16 fused_qkv dropout 0.1 flash", groups=measured,
        group_shape=[G, train_main.B, train_main.T], nonpad_tokens_per_group=nonpad,
        seconds=seconds, ms_per_group=seconds * 1e3 / measured,
        nonpad_tokens_per_s=nonpad * measured / seconds, losses=losses, applied=applied,
        kernel_launches=launches, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=card)
    want = G * cfg.n_layer * measured
    if any(n != want for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != G x n_layer x groups = {want}")
    if not all(applied) or not all(np.isfinite(losses)):
        raise AssertionError(f"a group failed: losses {losses}, applied {applied}")
    return launches


# --- phase 9: one group step on the card against the CPU -------------------------


def _parity_step(name, cfg, tree, run_cfg, loss_cfg, batch, tol, **step_kw) -> dict:
    """One group step from the JAX-layout ``tree`` on the card (kernels) and
    on the CPU (plain versions); loss, gradients and updated parameters
    compared under ``tol`` (``TRAIN_PARITY_TOL``'s keys)."""
    before = [w.launches for w in FLASH_WRAPPERS]
    results = {}
    for dev in ("cuda", "cpu"):
        model = params_from_jax(tree, cfg, dev).train()
        bundle = build_optimizer(run_cfg, model, total_steps=train_main.TOTAL_STEPS)
        kw = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in step_kw.items()}
        step = make_train_step(cfg, loss_cfg, **kw)
        m = step(model, bundle, {k: (t.to(dev) if isinstance(t, torch.Tensor) else t)
                                 for k, t in batch.items()}, None, 1.0)
        results[dev] = (float(m["total_loss_sum"]), bool(m["applied"]),
                        {n: (p.detach().cpu(), p.grad.cpu()) for n, p in
                         model.named_parameters() if p.grad is not None})
    launched = [w.launches - b for w, b in zip(FLASH_WRAPPERS, before)]
    (loss_g, ok_g, gpu), (loss_c, ok_c, cpu) = results["cuda"], results["cpu"]
    gmax = max(float(g.abs().max()) for _, g in cpu.values())
    grad_err = max(float((gpu[n][1] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * gmax)
                   for n, (_, g) in cpu.items())
    # (error, leaf, elements) of the parameters with a real gradient and of
    # those whose gradient is rounding noise
    worst = {"signal": (0.0, None, 0), "noise": (0.0, None, 0)}
    for n, (p, g) in cpu.items():
        noise = g.abs() < tol["noise_grad_share"] * gmax
        diff = (gpu[n][0] - p).abs()
        for key, sel in (("signal", ~noise), ("noise", noise)):
            count = int(sel.sum())
            err = float(diff[sel].max()) if count else 0.0
            best = worst[key]
            worst[key] = (max(err, best[0]), n if err > best[0] else best[1], best[2] + count)
    param_err, noise_err = worst["signal"][0], worst["noise"][0]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    grad_norm = float(torch.cat([g.reshape(-1) for _, g in cpu.values()]).norm())
    out = dict(case=name, loss_card=loss_g, loss_cpu=loss_c, loss_rel_err=loss_err,
               grad_rel_err=grad_err, param_abs_err=param_err,
               param_abs_err_leaf=worst["signal"][1], noise_param_abs_err=noise_err,
               noise_param_abs_err_leaf=worst["noise"][1], noise_elements=worst["noise"][2],
               signal_elements=worst["signal"][2], trained_tensors=len(cpu),
               applied_grad_norm=grad_norm, kernel_launches=launched, tol=tol)
    log("train_parity", **out)
    if not (ok_g and ok_c) or min(launched) == 0:
        raise AssertionError(f"{name}: the parity step was not applied or launched no kernel")
    if (loss_err > tol["loss_rtol"] or grad_err > tol["grad_rtol"]
            or param_err > tol["param_atol"] or noise_err > tol["noise_param_atol"]):
        raise AssertionError(f"{name}: the card's step disagrees with the CPU's")
    return out


def phase_train_parity() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CodonGPTConfig(**dict(train_main.MAIN_TRAIN, n_layer=2, dropout=0.0,
                                compute_dtype="float32"))
    torch.manual_seed(3)
    tree = params_to_jax(CodonGPT(cfg), cfg)
    run_cfg = dict(train_main.RUN_CFG, warmup_steps=0)  # the full lr, 3e-4
    batch = train_main.make_batch(7, "cpu", groups=2, batch=4)
    _parity_step("adamw", cfg, tree, run_cfg, LossConfig(), batch, TRAIN_PARITY_TOL)

    # every objective and option of the fine-tuning slice at once: two offset
    # heads, the termination and replay losses, shape guidance through the
    # encoder, LoRA r8 under lora_only, Adafactor and an active grad_clip
    ocfg = cfg.replace(termination_aux=True, multi_offset_targets=(2, 3),
                       use_shape_guidance=True)
    torch.manual_seed(4)
    base = CodonGPT(ocfg)
    base.shape_encoder = ShapeEncoder()
    rng = np.random.default_rng(4)
    tree = lora_lib.add_lora_adapters(params_to_jax(base, ocfg), rng, rank=8)
    for name in ("query", "key", "value", "proj"):  # adapters off their zero start
        b = tree["blocks"]["attn"][name]["lora_b"]
        tree["blocks"]["attn"][name]["lora_b"] = (0.02 * rng.standard_normal(b.shape)
                                                  ).astype(np.float32)
    tree["shape_proj"]["w"] = (0.1 * rng.standard_normal((3, ocfg.n_embd))).astype(np.float32)
    loss_cfg = LossConfig(multi_offset_weights=((2, 0.3), (3, 0.2)), label_smoothing=0.05,
                          termination_enabled=True, termination_stop_ids=STOP_IDS,
                          replay_enabled=True, replay_weight=0.5)
    replay_x = torch.from_numpy(rng.integers(4, 68, (4, train_main.T)))
    replay_labels = torch.full((4, train_main.T), -100)
    replay_labels[:, 100:400:50] = torch.from_numpy(rng.integers(0, 5, (4, 6)))
    batch = dict(train_main.make_batch(8, "cpu", groups=2, batch=4), replay_x=replay_x,
                 replay_labels=replay_labels, replay_mask=[False, True])
    run_cfg = dict(run_cfg, optimizer="adafactor", grad_clip=OBJECTIVES_GRAD_CLIP, lora_rank=8)
    out = _parity_step("objectives_lora_adafactor_clip", ocfg, tree, run_cfg, loss_cfg, batch,
                       TRAIN_PARITY_OBJECTIVES_TOL, use_replay=True,
                       shape_lookup=torch.from_numpy(shape_lookup_table()))
    # the clipped gradient's norm is the clip's: it was active
    if abs(out["applied_grad_norm"] - OBJECTIVES_GRAD_CLIP) > 1e-4 * OBJECTIVES_GRAD_CLIP:
        raise AssertionError(f"grad_clip was not active: norm {out['applied_grad_norm']}")


# --- phase 10: the verify-chunk kernel against its plain version -----------------


def chunk_case(gen, L, B, S, Hkv, G, T, D, cache_dtype, q_dtype, gap=False, full=False):
    """Random packed caches, a (B, Hq, T, D) chunk query and the verify's
    (B, T, S) mask: row t attends positions below length + t + 1 (the
    intra-chunk staircase); ``gap`` blocks a segment below every length;
    ``full`` puts every slot at length S - T, so no cache tile is dead."""
    dev = "cuda"
    _, k, v, _, ks, vs = make_case(gen, L, B, S, Hkv, G, D, cache_dtype, q_dtype)
    q = torch.randn((B, Hkv * G, T, D), generator=gen, device=dev).to(q_dtype)
    lengths = torch.randint(1, S - T + 1, (B,), generator=gen, device=dev)
    if full:
        lengths.fill_(S - T)
    pos = torch.arange(S, device=dev)
    valid = pos[None, None, :] < (lengths[:, None] + torch.arange(T, device=dev) + 1)[:, :, None]
    if gap:
        # positions [length/4, length/2) belong to an earlier segment
        lo, hi = lengths // 4, lengths // 2
        valid &= ~((pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None]))[:, None, :]
    mask = torch.zeros((B, T, S), device=dev).masked_fill_(~valid, da.NEG_INF)
    return q, k, v, mask, ks, vs


def chunk_bound(q, k, v, mask, layer, ks, vs, Hkv):
    """Per-element bound on |bf16 chunk kernel - plain version| (see
    ``CHUNK_BF16_TOL_REASON``): ``CHUNK_BF16_TOL`` times the row's
    sum_j p_j |v_j| (v_j times its scale for an int8 cache), plus 1e-5."""
    mag = da.decode_attention_chunk_reference(q, k, v.abs(), mask, layer, ks, vs, kv_heads=Hkv)
    return CHUNK_BF16_TOL * mag + 1e-5


def chunk_fault_ratios(q, k, v, mask, ks, vs, Hkv) -> dict:
    """How far two faults the bound must catch move the plain version on
    layer 0, as the largest ratio of error to ``chunk_bound`` (> 1: caught):
    the first live tile of every slot that has two skipped, and each slot
    given the previous slot's mask rows. None where the case has no such
    fault (every slot one live tile, or every slot the same mask)."""
    want = da.decode_attention_chunk_reference(q, k, v, mask, 0, ks, vs, kv_heads=Hkv)
    bound = chunk_bound(q, k, v, mask, 0, ks, vs, Hkv)
    live = da.chunk_live_tiles(mask)
    skipped = mask.clone()
    for b in range(mask.shape[0]):
        tiles = torch.nonzero(live[b]).flatten().tolist()
        if len(tiles) >= 2:
            j0 = tiles[0] * da.CHUNK_TILE
            skipped[b, :, j0:j0 + da.CHUNK_TILE] = da.NEG_INF
    out = {}
    for fault, m in (("skipped_live_tile", skipped), ("other_slot_mask", mask.roll(1, 0))):
        if torch.equal(m, mask):
            out[fault] = None
            continue
        got = da.decode_attention_chunk_reference(q, k, v, m, 0, ks, vs, kv_heads=Hkv)
        out[fault] = float(((got - want).abs() / bound).max())
    return out


def check_chunk_case(gen, phase, name, L, B, S, Hkv, G, T, D, cdt, qdt, gap, full,
                     peak_bw, peak_ops):
    """The chunk kernel against its plain version on every layer of one case
    (``chunk_case``): a bf16 query within ``chunk_bound`` per element, which
    the case's faults must exceed, a float32 one within ``KERNEL_ATOL``.
    Logs the case under ``phase`` and raises on a failure. Returns the
    case's tensors, the largest error and its ``decode_bounds``."""
    q, k, v, mask, ks, vs = chunk_case(gen, L, B, S, Hkv, G, T, D, cdt, qdt, gap, full)
    tensor_core = qdt == torch.bfloat16
    err = ratio = 0.0
    for layer in range(L):
        got = da.decode_attention_chunk(q, k, v, mask, layer, ks, vs, kv_heads=Hkv)
        want = da.decode_attention_chunk_reference(q, k, v, mask, layer, ks, vs,
                                                   kv_heads=Hkv)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"chunk {name}: non-finite kernel output")
        diff = (got - want).abs()
        err = max(err, float(diff.max()))
        bound = (chunk_bound(q, k, v, mask, layer, ks, vs, Hkv) if tensor_core
                 else KERNEL_ATOL)
        ratio = max(ratio, float((diff / bound).max()))
    bounds = decode_bounds(mask, B, S, Hkv, G, D, k.element_size(), q.element_size(),
                           ks is not None, peak_bw, peak_ops, T=T)
    check = (dict(tol=f"{CHUNK_BF16_TOL} * sum_j p_j |v_j| + 1e-5",
                  tol_reason=CHUNK_BF16_TOL_REASON,
                  fault_ratios=chunk_fault_ratios(q, k, v, mask, ks, vs, Hkv))
             if tensor_core else dict(tol=KERNEL_ATOL, tol_reason=KERNEL_ATOL_REASON))
    log(phase, case=name, shape=dict(L=L, B=B, S=S, Hkv=Hkv, Hq=Hkv * G, T=T, D=D),
        cache=str(cdt).removeprefix("torch."), query=str(qdt).removeprefix("torch."),
        segment_gap=gap, full=full, **bounds[0], max_abs_err=err, err_over_bound=ratio,
        **check)
    if ratio > 1.0:
        raise AssertionError(f"chunk {name}: kernel disagrees with its plain version "
                             f"(error {ratio} x its bound)")
    if tensor_core and any(r is not None and r <= 1.0
                           for r in check["fault_ratios"].values()):
        raise AssertionError(f"chunk {name}: the bound would miss a fault "
                             f"{check['fault_ratios']}")
    return q, k, v, mask, ks, vs, err, bounds


def time_chunk_case(phase, name, case) -> dict:
    """The chunk kernel's time on a case ``check_chunk_case`` returned, a
    sweep of all its layers so every launch reads its layer cold, beside its
    bound, the plain version's time and SDPA's with the dense mask (bf16
    cache only); logged under ``phase``."""
    q, k, v, mask, ks, vs, err, (tiles, needed, read, bound) = case
    L, B, S, P = k.shape
    D = q.shape[-1]
    Hkv = P // D

    def sweep(fn):
        return lambda: [fn(q, k, v, mask, layer, ks, vs, kv_heads=Hkv) for layer in range(L)]

    kernel_ms = median_ms(sweep(da.decode_attention_chunk)) / L
    plain_ms = median_ms(sweep(da.decode_attention_chunk_reference), runs=9) / L
    library_ms = None
    if ks is None:
        am = mask[:, None].to(q.dtype)  # (B, 1, T, S)

        def sweep_library():
            for layer in range(L):
                kl = k[layer].view(B, S, Hkv, D).transpose(1, 2)
                vl = v[layer].view(B, S, Hkv, D).transpose(1, 2)
                torch.nn.functional.scaled_dot_product_attention(
                    q, kl, vl, attn_mask=am, enable_gqa=True)

        library_ms = median_ms(sweep_library) / L
    # the bound of what the mask needs (positions live in some row) goes
    # into the kernels line; the full cache's and that of the tiles the
    # kernel reads (whole tiles) are logged beside it
    b_ms, b_by, nbytes = bound["needed"]
    timed = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=library_ms, max_abs_err=err)
    log(phase, case=name, bytes=nbytes, positions_needed=needed, positions_read=read, **tiles,
        **timed, full_bound_ms=bound["full"][0], live_bound_ms=bound["read"][0],
        achieved_gb_per_s=nbytes / (kernel_ms * 1e-3) / 1e9, roofline_share=b_ms / kernel_ms,
        full_roofline_share=bound["full"][0] / kernel_ms,
        live_roofline_share=bound["read"][0] / kernel_ms)
    return timed


def phase_chunk(peak_bw, peak_ops) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    S_spec = 384  # ENGINE's cache with K+1 = 5 positions of headroom, rounded to 128
    cases = [
        # name, L, B, S, Hkv, G, T, D, cache dtype, q dtype, gap, full, timed
        ("main_bf16", 10, 64, S_spec, 8, 1, 5, 48, bf16, bf16, False, False, True),
        ("main_int8", 10, 64, S_spec, 8, 1, 5, 48, i8, bf16, False, False, True),
        ("full_bf16", 10, 64, S_spec, 8, 1, 5, 48, bf16, bf16, False, True, True),
        ("full_int8", 10, 64, S_spec, 8, 1, 5, 48, i8, bf16, False, True, True),
        # what bounds the kernel: fewer and more blocks than a wave, the same
        # bytes as whole rows of one kv head, twice the cache, one query a slot
        ("full_b16_bf16", 10, 16, S_spec, 8, 1, 5, 48, bf16, bf16, False, True, True),
        ("full_b128_bf16", 10, 128, S_spec, 8, 1, 5, 48, bf16, bf16, False, True, True),
        ("full_rows_b512_bf16", 10, 512, S_spec, 1, 1, 5, 48, bf16, bf16, False, True, True),
        ("full_s768_bf16", 10, 64, 768, 8, 1, 5, 48, bf16, bf16, False, True, True),
        ("full_t1_bf16", 10, 64, S_spec, 8, 1, 1, 48, bf16, bf16, False, True, True),
        ("gqa4_bf16", 4, 64, S_spec, 2, 4, 5, 48, bf16, bf16, False, False, False),
        ("t1_bf16", 2, 64, S_spec, 8, 1, 1, 48, bf16, bf16, False, False, False),
        ("t8_bf16", 2, 64, S_spec, 8, 1, 8, 48, bf16, bf16, False, False, False),
        ("t8_gqa4_int8", 2, 16, S_spec, 2, 4, 8, 48, i8, bf16, False, False, False),
        ("offgrid_s130_b5", 2, 5, 130, 8, 1, 5, 48, bf16, bf16, False, False, False),
        ("d20_f32", 2, 5, 130, 2, 2, 5, 20, f32, f32, False, False, False),
        ("scalar_loads_d20_bf16", 2, 3, 77, 2, 2, 5, 20, bf16, bf16, False, False, False),
        ("segment_gap_staircase", 2, 8, 256, 8, 1, 5, 48, bf16, bf16, True, False, False),
        ("d128_r32_int8", 2, 8, 200, 1, 4, 8, 128, i8, bf16, True, False, False),
    ]
    timed = {}
    for name, L, B, S, Hkv, G, T, D, cdt, qdt, gap, full, is_timed in cases:
        case = check_chunk_case(gen, "chunk", name, L, B, S, Hkv, G, T, D, cdt, qdt, gap, full,
                                peak_bw, peak_ops)
        if is_timed:
            timed[name] = time_chunk_case("chunk_time", name, case)
    return timed


# --- phase 11: the streamed kernel against its plain version ---------------------


def phase_streamed(peak_bw, peak_ops) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        # name, L, B, S, Hkv, G, D, cache dtype, q dtype, block_s, wholly masked split
        ("main_bf16", 10, 64, 256, 8, 1, 48, bf16, bf16, None, None),
        ("main_int8", 10, 64, 256, 8, 1, 48, i8, bf16, None, None),
        ("gqa4_bf16", 4, 64, 256, 2, 4, 48, bf16, bf16, None, None),
        ("gqa4_int8", 4, 64, 256, 2, 4, 48, i8, bf16, None, None),
        ("g8_d64_bf16", 2, 16, 512, 1, 8, 64, bf16, bf16, None, None),
        ("offgrid_f32_d16", 2, 5, 130, 4, 2, 16, f32, f32, None, None),
        ("offgrid_bf16", 2, 5, 130, 8, 1, 48, bf16, bf16, None, None),
        ("scalar_loads_d20", 2, 3, 77, 2, 2, 20, bf16, bf16, None, None),
        ("int8_f32_query", 2, 5, 130, 2, 2, 48, i8, f32, None, None),
        ("first_split_masked", 2, 64, 256, 8, 1, 48, bf16, bf16, 64, "first"),
        ("block_s16_int8", 2, 16, 256, 8, 1, 48, i8, bf16, 16, None),
        ("block_s32_bf16", 2, 16, 256, 8, 1, 48, bf16, bf16, 32, None),
        # a split with no live position between two live ones
        ("middle_split_masked", 2, 64, 256, 8, 1, 48, bf16, bf16, 64, "middle"),
        ("middle_split_masked_int8", 2, 64, 256, 8, 1, 48, i8, bf16, 64, "middle"),
    ]
    for name, L, B, S, Hkv, G, D, cdt, qdt, block_s, masked in cases:
        q, k, v, mask, ks, vs = make_case(gen, L, B, S, Hkv, G, D, cdt, qdt)
        if masked == "first":
            mask[:, :block_s] = da.NEG_INF  # every row's whole first split
            mask[:, S - 1] = 0.0
        elif masked == "middle":
            mask[:, :block_s] = 0.0
            mask[:, block_s:2 * block_s] = da.NEG_INF  # every row's whole second split
            mask[:, 2 * block_s] = 0.0
        # splits of 16 or 32 lie inside the cache's tiles, splits of 64k are
        # whole tiles: either way a split never reads a dead tile's position
        pk, pv, pks, pvs = poison_dead_tiles(k, v, ks, vs, mask)
        err = nan_err = 0.0
        for layer in range(L):
            got = da.decode_attention_streamed(q, k, v, mask, layer, ks, vs, kv_heads=Hkv,
                                               block_s=block_s)
            want = da.decode_attention_streamed_reference(q, k, v, mask, layer, ks, vs,
                                                          kv_heads=Hkv, block_s=block_s)
            got_poisoned = da.decode_attention_streamed(q, pk, pv, mask, layer, pks, pvs,
                                                        kv_heads=Hkv, block_s=block_s)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"streamed {name}: non-finite kernel output")
            err = max(err, max_err(got, want))
            nan_err = max(nan_err, max_err(got_poisoned, want))
        del pk, pv, pks, pvs
        log("streamed", case=name, shape=dict(L=L, B=B, S=S, Hkv=Hkv, Hq=Hkv * G, D=D),
            cache=str(cdt).removeprefix("torch."),
            block_s=block_s or da.stream_block_s(B, Hkv, S, sms), masked_split=masked,
            max_abs_err=err, nan_dead_tiles_err=nan_err, tol=KERNEL_ATOL,
            tol_reason=KERNEL_ATOL_REASON)
        if err > KERNEL_ATOL or nan_err > KERNEL_ATOL:
            raise AssertionError(f"streamed {name}: kernel disagrees with its plain version "
                                 f"({err}; with NaN in the dead tiles {nan_err}; "
                                 f"tolerance {KERNEL_ATOL})")

    timed = {}
    for name, B, cdt in (("b64_bf16", 64, bf16), ("b64_int8", 64, i8),
                         ("b256_bf16", 256, bf16), ("b256_int8", 256, i8)):
        L, S, Hkv, G, D = 10, 256, 8, 1, 48
        q, k, v, mask, ks, vs = make_case(gen, L, B, S, Hkv, G, D, cdt, bf16)
        pk, pv, pks, pvs = poison_dead_tiles(k, v, ks, vs, mask)
        err = nan_err = 0.0
        for layer in range(L):
            want = da.decode_attention_streamed_reference(q, k, v, mask, layer, ks, vs,
                                                          kv_heads=Hkv)
            err = max(err, max_err(da.decode_attention_streamed(
                q, k, v, mask, layer, ks, vs, kv_heads=Hkv), want))
            nan_err = max(nan_err, max_err(da.decode_attention_streamed(
                q, pk, pv, mask, layer, pks, pvs, kv_heads=Hkv), want))
        del pk, pv, pks, pvs
        if err > KERNEL_ATOL or nan_err > KERNEL_ATOL:
            raise AssertionError(f"streamed {name}: kernel disagrees ({err}, {nan_err})")
        blocked_ms = median_ms(lambda: [da.decode_attention(q, k, v, mask, layer, ks, vs,
                                                            kv_heads=Hkv)
                                        for layer in range(L)]) / L
        timed[name] = time_decode_case(name, q, k, v, mask, ks, vs, Hkv, G,
                                       da.decode_attention_streamed, peak_bw, peak_ops, err,
                                       nan_err, "streamed_time",
                                       block_s=da.stream_block_s(B, Hkv, S, sms),
                                       blocked_ms=blocked_ms)
        if name == "b64_bf16":  # what splitting S would cost or buy here (the default: none)
            split_ms = {block_s: median_ms(lambda: [da.decode_attention_streamed(
                q, k, v, mask, layer, ks, vs, kv_heads=Hkv, block_s=block_s)
                for layer in range(L)]) / L for block_s in (64, 128)}
            log("streamed_splits", case=name, ms=timed[name]["ms"],
                block_s=da.stream_block_s(B, Hkv, S, sms), ms_by_block_s=split_ms)

    # the streamed kernel's path: the decode-attention chain benchmark
    da.decode_attention_streamed.launches = 0
    report = bench_decode.run(bench_decode.parse_args([]))
    launches = da.decode_attention_streamed.launches
    log("bench_decode_kernel", **report, streamed_launches=launches)
    if launches == 0:
        raise AssertionError("the decode-kernel benchmark launched no streamed kernel")
    return {"timed": timed, "launches": launches}


# --- phase 12: the speculative serving main path ---------------------------------


def phase_spec_serve(model, cfg, card: str) -> dict:
    rng = np.random.default_rng(0)
    warm = build_requests(rng, 8)
    reqs = build_requests(rng, REQUESTS)  # the requests of phase_serve
    out = {}
    for kv_quant in (False, True):
        spec = dict(speculative_k=SPECULATIVE_K, draft_table=fit_draft_table(model, cfg, kv_quant))
        drain(model, cfg, warm, kv_quant, **spec)
        torch.cuda.reset_peak_memory_stats()
        # the counts of the main path's run only
        da.decode_attention_chunk.launches = 0
        da.decode_attention.launches = 0
        results, seconds, eng = drain(model, cfg, reqs, kv_quant, **spec)
        chunk_launches = da.decode_attention_chunk.launches
        decode_launches = da.decode_attention.launches
        stats = eng.stats()
        rounds = stats["verify_rounds"]
        delivered = sum(len(r.tokens) for r in results.values())
        log("spec_serve", model="10L8H d384 bf16 fused_qkv", kv_quant=kv_quant,
            speculative_k=SPECULATIVE_K, requests=len(reqs), slots=ENGINE["slots"],
            rounds_per_sync=ENGINE["steps_per_sync"], cache_positions=eng.state["k"].shape[2],
            delivered_tokens=delivered, seconds=seconds,
            delivered_tokens_per_s=delivered / seconds, verify_rounds=rounds,
            ms_per_round=seconds * 1e3 / rounds,
            delivered_tokens_per_round=delivered / rounds,
            tokens_per_slot_round=stats["speculative_tokens_per_round"],
            accept_rate=stats["speculative_accept_rate"],
            chunk_kernel_launches=chunk_launches, decode_kernel_launches=decode_launches,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
        if chunk_launches == 0 or chunk_launches != cfg.n_layer * rounds:
            raise AssertionError(f"chunk launches {chunk_launches} != n_layer x rounds "
                                 f"({cfg.n_layer} x {rounds})")
        if decode_launches != 0:
            raise AssertionError(f"the speculative drain launched the decode kernel "
                                 f"{decode_launches} times")
        out[kv_quant] = chunk_launches
        # the plain engine on the same requests in the same call, for the record
        results, seconds, eng = drain(model, cfg, reqs, kv_quant)
        delivered = sum(len(r.tokens) for r in results.values())
        log("spec_serve_plain", kv_quant=kv_quant, delivered_tokens=delivered,
            seconds=seconds, delivered_tokens_per_s=delivered / seconds,
            decode_steps=eng.stats()["decode_steps"], card=card)
    return {"launches": out[False], "launches_int8": out[True]}


# --- phase 13: speculative serving on the card against the CPU -------------------


def phase_spec_parity() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CodonGPTConfig(**dict(MAIN, n_layer=2, block_size=256, compute_dtype="float32"))
    torch.manual_seed(1)
    cpu_model = CodonGPT(cfg).eval()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(1)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], 24) for n in (9, 23, 40, 17)]
    reqs[1][0][7] = 3  # a <SEP> inside one prompt
    table = fit_bigram_table(rng.integers(0, 68, 4000), 68)

    def tokens(model, device, **kw):
        eng = ServingEngine(model, cfg, slots=4, max_seq_len=128, steps_per_sync=8,
                            device=device, **kw)
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        return [res[r].tokens for r in rids]

    spec = dict(speculative_k=SPECULATIVE_K, draft_table=table)
    before = da.decode_attention_chunk.launches
    on_card, on_cpu = tokens(gpu_model, "cuda", **spec), tokens(cpu_model, "cpu", **spec)
    launched = da.decode_attention_chunk.launches - before
    plain_card = tokens(gpu_model, "cuda")

    allowed = np.zeros(68, bool)
    allowed[4:] = True  # the CDS codons
    prompts = np.concatenate([np.ones((3, 1), np.int64), rng.integers(4, 68, (3, 6))], 1)
    masked_spec, _, _ = generate_tokens_speculative(
        gpu_model, cfg, prompts, 24, None, restrict_table(table, allowed), SPECULATIVE_K,
        0.0, False, allowed, device="cuda")
    masked_plain = generate_masked_tokens(gpu_model, cfg, prompts, 24, None, 0.0, allowed,
                                          device="cuda")
    same = on_card == on_cpu
    same_plain = on_card == plain_card
    same_masked = bool(torch.equal(masked_spec, masked_plain))
    log("spec_parity", model="2L8H d384 f32", prompts=len(reqs), identical_tokens=same,
        identical_to_plain_engine=same_plain, masked_identical=same_masked,
        chunk_kernel_launches=launched)
    if not (same and same_plain and same_masked) or launched == 0:
        raise AssertionError("greedy speculative tokens differ between card, CPU and the "
                             "plain path")



# --- phase 14: bench.py's protocols, the real host pipeline ----------------------


# the smoke's depth of each protocol (``bench_pipeline.py`` itself measures 20
# groups and profiles 3): the phase checks the path, the CLI measures it
PIPELINE_DEPTH = dict(measure=2, profile_groups=1)


def phase_pipeline(card: str) -> dict:
    built = train_main.build_main("cuda")
    cfg = built[0]
    gen = torch.Generator(device="cuda").manual_seed(train_main.SEED)
    runs = {}
    d = PIPELINE_DEPTH
    for name, run in (("synthetic", lambda: bench_pipe.run_synthetic(built, gen, **d)),
                      ("multi", lambda: bench_pipe.run_real_pipeline(built, gen, "multi", **d)),
                      ("binpack", lambda: bench_pipe.run_real_pipeline(built, gen, "binpack",
                                                                       **d))):
        for w in FLASH_WRAPPERS:
            w.launches = 0  # this protocol's run only
        r = run()
        launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
        want = train_main.G * cfg.n_layer * r["groups_run"]
        log("pipeline", protocol=r["protocol"], nonpad_tokens_per_s=r["value"],
            pad_fraction=r.get("pad_fraction"), ms_per_group=r["ms_per_group"],
            fetch_ms_per_group=r["fetch_ms_per_group"],
            device_ms_per_group=r["device_ms_per_group"],
            flash_ms_per_group=r["flash_ms_per_group"],
            device_busy_share=r["device_busy_share"],
            device_busy_share_profiled=r["device_busy_share_profiled"],
            h2d_copies_per_group=r["h2d_copies_per_group"],
            h2d_copy_ms_per_group=r["h2d_copy_ms_per_group"],
            kernel_launches_per_group=r["kernel_launches_per_group"],
            nonpad_tokens_per_group=r["nonpad_tokens_per_group"],
            device_nonpad_equals_host=r["device_nonpad_equals_host"],
            groups_run=r["groups_run"], flash_launches=launches, want_launches=want,
            dataset_build_s=r.get("dataset_build_s"), windows=r.get("windows"),
            storage=r.get("storage"), card=card)
        if not r["device_nonpad_equals_host"]:
            raise AssertionError(f"{name}: the card's non-pad counts differ from the host's")
        if any(n != want for n in launches.values()):
            raise AssertionError(f"{name}: flash launches {launches} != G x n_layer x "
                                 f"groups = {want}")
        runs[name] = r
    line = bench_pipe.summarize(runs["synthetic"], runs["multi"], runs["binpack"])
    log("pipeline_line", **{k: line[k] for k in ("metric", "value", "vs_baseline",
                                                   "protocol", "pad_fraction")},
        reference_packing_protocol={k: line["reference_packing_protocol"][k] for k in
                                    ("value", "vs_baseline", "protocol")},
        synthetic_device_only={k: line["synthetic_device_only"][k] for k in
                               ("value", "vs_baseline")}, card=card)
    return line


# --- phase 15: the train CLI on a packed corpus ----------------------------------

TRAINER_GROUPS_PER_EPOCH = 4
TRAINER_VAL_WINDOWS = 64


def packed_corpus(workdir: Path, n_train: int, n_val: int) -> None:
    """``train.npz`` / ``val.npz`` in ``workdir``: ``n_train`` and ``n_val``
    packed binpack windows from ``build_packed_dataset`` with mmap
    sidecars, and the codon itos beside them."""
    npz, _ = bench_pipe.build_packed_dataset(n_train + n_val, train_main.T,
                                             workdir / "build", pack_mode="binpack")
    with np.load(npz) as data:
        X, Y = data["X"], data["Y"]
    for name, sl in (("train", slice(0, n_train)), ("val", slice(n_train, n_train + n_val))):
        np.savez(workdir / f"{name}.npz", X=X[sl], Y=Y[sl])
        np.save(workdir / f"{name}_X.npy", X[sl])
        np.save(workdir / f"{name}_Y.npy", Y[sl])
    write_itos(workdir / "itos.txt")


def run_yaml(path: Path, train_npz: Path, val_npz: Path, *, G: int, epochs: int,
             run_id: str) -> Path:
    """A YAML run config at the training main path's width (10L8H d384,
    block 512, bf16 flash, fused QKV, tied embeddings, dropout 0.1, label
    smoothing 0.05, AdamW lr 1e-3 under a cosine schedule, B 8) with its
    paths under a ``data:`` map."""
    m = train_main.MAIN_TRAIN
    lines = [
        "data:",
        f"  train_npz: {train_npz}",
        f"  val_npz: {val_npz}",
        "use_mmap_dataset: true",
        f"block_size: {m['block_size']}", f"n_layer: {m['n_layer']}",
        f"n_head: {m['n_head']}", f"n_embd: {m['n_embd']}",
        f"dropout: {m['dropout']}", f"label_smoothing: {m['label_smoothing']}",
        f"sep_id: {m['sep_id']}", "tie_embeddings: true", "fused_qkv: true",
        "attention_impl: flash", "compute_dtype: bfloat16",
        f"batch_size: {train_main.B}", f"grad_accum_steps: {G}",
        "lr: 0.001", "lr_embedding: 0.001", "min_lr: 0.0001", "weight_decay: 0.05",
        "warmup_steps: 2", "scheduler: cosine", f"epochs: {epochs}", "seed: 1337",
        f"run_id: {run_id}", "early_stop_patience: 0",
    ]
    path.write_text("\n".join(lines) + "\n")
    return path


def trainer_config(workdir: Path) -> Path:
    """A packed corpus (``packed_corpus``: train windows for 4 groups an
    epoch, 64 validation windows) and the main path's run config over it
    (G 16, 2 epochs)."""
    G, B = train_main.G, train_main.B
    packed_corpus(workdir, TRAINER_GROUPS_PER_EPOCH * G * B, TRAINER_VAL_WINDOWS)
    return run_yaml(workdir / "trainer.yaml", workdir / "train.npz", workdir / "val.npz",
                    G=G, epochs=2, run_id="smoke-trainer")


def phase_trainer(card: str, workdir: Path | None = None) -> dict:
    """The train CLI on a packed corpus in ``workdir`` (a temporary directory
    by default); the run stays there for the phases that read it."""
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="smoke_trainer_") as tmp:
            return phase_trainer(card, Path(tmp))
    tmp = Path(workdir)
    config = trainer_config(tmp)
    runs = tmp / "runs"
    run_dir = runs / "smoke-trainer"
    last = run_dir / "checkpoints" / "last.npz"
    argv = ["--config", str(config), "--run_root", str(runs)]
    for w in FLASH_WRAPPERS:
        w.launches = 0  # the main path's run only: 2 epochs, then the resume
    t0 = time.perf_counter()
    rc = train_cli(argv)
    first_s = time.perf_counter() - t0
    refused = None
    try:
        train_cli(argv + ["--resume", str(last)])
    except RunLifecycleError as exc:
        refused = str(exc)
    config.write_text(config.read_text().replace("epochs: 2", "epochs: 3"))
    t0 = time.perf_counter()
    rc_resume = train_cli(argv + ["--resume", str(last)])
    resume_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}

    artifacts = ["checkpoints/last.npz", "checkpoints/best.npz",
                 "checkpoints/best_epoch_001.npz", "checkpoints/meta.json",
                 "checkpoints/config.yaml", "scores/curves.csv",
                 "scores/metrics.json", "itos.txt", "vocabulary.json",
                 "run_complete.json", "run_complete_epoch_002.json"]
    missing = [a for a in artifacts if not (run_dir / a).exists()]
    rows = (run_dir / "scores" / "curves.csv").read_text().strip().splitlines()[1:]
    payload = load_checkpoint(last)
    meta = json.loads((run_dir / "checkpoints" / "meta.json").read_text())
    epochs = [load_checkpoint(run_dir / "checkpoints" / f"best_epoch_{e:03d}.npz")
              for e in (1, 2, 3)
              if (run_dir / "checkpoints" / f"best_epoch_{e:03d}.npz").exists()]
    train_losses = [float(r.split(",")[1]) for r in rows]
    val_losses = [float(r.split(",")[2]) for r in rows]
    groups = int(payload["step"])

    # the validation loss again, from last.npz through the loader
    mcfg = CodonGPTConfig.from_run_config(payload["cfg"])
    model = params_from_jax(payload["model"], mcfg, "cuda")
    step = make_eval_step(mcfg, LossConfig())
    val = PackedDataset(str(tmp / "val.npz"), use_mmap=True)
    plan = EpochPlan(val, batch_size=train_main.B, seed=1337, epoch=0, shuffle=False)
    losses = [float(step(model, torch.from_numpy(x).cuda().long(),
                         torch.from_numpy(y).cuda().long())["total_loss"])
              for x, y in plan.microbatches()]
    reloaded_val = sum(losses) / len(losses)
    val_mb = len(losses)
    G, L = train_main.G, mcfg.n_layer
    want_bwd = G * L * groups
    want_fwd = want_bwd + L * val_mb * len(rows)
    val_err = abs(reloaded_val - float(payload["val_loss"])) / abs(float(payload["val_loss"]))
    log("trainer", model="10L8H d384 bf16 fused_qkv dropout 0.1 flash",
        rc=rc, rc_resume=rc_resume, first_run_s=first_s, resume_run_s=resume_s,
        refused_same_epochs=refused is not None, curves_rows=len(rows),
        train_losses=train_losses, val_losses=val_losses, groups=groups,
        status=meta["status"], missing_artifacts=missing, flash_launches=launches,
        want_fwd=want_fwd, want_bwd=want_bwd, reloaded_val_loss=reloaded_val,
        checkpoint_val_loss=float(payload["val_loss"]), reloaded_val_rel_err=val_err,
        best_epochs=len(epochs), peak_mem_gib=meta["runtime_memory"]["device_peak_bytes"] / 2**30,
        card=card)
    if rc or rc_resume or refused is None or missing or len(rows) != 3:
        raise AssertionError("the train CLI's runs or artifacts are wrong")
    if groups != 3 * TRAINER_GROUPS_PER_EPOCH or meta["status"] != "completed":
        raise AssertionError(f"{groups} groups, status {meta['status']}")
    if not all(np.isfinite(train_losses + val_losses)) or not (
            train_losses[-1] < train_losses[0] and val_losses[-1] < val_losses[0]):
        raise AssertionError(f"losses not finite and falling: {train_losses}, {val_losses}")
    if (launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] != want_bwd
            or launches["flash_bwd_dkv"] != want_bwd):
        raise AssertionError(f"flash launches {launches}: want fwd {want_fwd}, "
                             f"dq/dkv {want_bwd}")
    if val_err > TRAINER_RELOAD_RTOL:
        raise AssertionError(f"last.npz gives validation loss {reloaded_val}, the run "
                             f"recorded {payload['val_loss']}")
    return {"launches": launches, "groups": groups, "run_dir": run_dir,
            "val_npz": tmp / "val.npz"}


# --- phase 16: speculative decoding on a trained model ---------------------------


def check_spec_trained_kernels(report: dict, peak_bw, peak_ops) -> None:
    """The decode kernel at the cache positions of the plain protocols and
    the chunk kernel (T = K + 1) at those of the speculative ones, on the
    trained model's layers, batch and heads, as ``report`` gives them."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16, i8 = torch.bfloat16, torch.int8
    L, B, K = report["n_layer"], report["batch_size"], report["n_draft"]
    Hkv, D = report["kv_heads"], report["head_dim"]
    G = report["n_head"] // Hkv
    positions = report["cache_positions"]
    decode_S = sorted({S for key, S in positions.items() if key.endswith("_plain")})
    chunk_S = sorted({S for key, S in positions.items() if key.endswith("_speculative")})
    for S in decode_S:
        for cdt, lengths in ((bf16, "random"), (i8, "random"), (bf16, "full")):
            name = f"decode_s{S}_{'int8' if cdt == i8 else 'bf16'}_{lengths}"
            check_decode_case(gen, "spec_trained_kernel", name, L, B, S, Hkv, G, D, cdt,
                              bf16, lengths)
    for S in chunk_S:
        for cdt, full in ((bf16, False), (i8, False), (bf16, True)):
            name = f"chunk_s{S}_{'int8' if cdt == i8 else 'bf16'}_{'full' if full else 'random'}"
            check_chunk_case(gen, "spec_trained_kernel", name, L, B, S, Hkv, G, K + 1, D, cdt,
                             bf16, False, full, peak_bw, peak_ops)


def phase_spec_trained(card: str, peak_bw, peak_ops) -> dict:
    args = bench_spec.parser().parse_args(["--repeats", "2"])
    da.decode_attention_chunk.launches = 0
    da.decode_attention.launches = 0
    report = bench_spec.run(args, "cuda")
    log("spec_trained", **{k: report[k] for k in (
        "model", "accept_rate", "tokens_per_round", "serving_accept_rate",
        "serving_tokens_per_slot_round", "serving_plain_tok_per_sec",
        "serving_plain_samples", "serving_speculative_tok_per_sec",
        "serving_speculative_samples", "speedup_serving", "offline_plain_tok_per_sec",
        "offline_speculative_tok_per_sec", "speedup_offline", "verify_rounds",
        "chunk_kernel_launches", "val_loss", "val_next_loss", "chain_entropy_rate_nats",
        "train_sec", "n_draft", "batch_size", "decode_tokens", "temperature",
        "cache_positions", "kv_heads", "head_dim")},
        decode_kernel_launches=da.decode_attention.launches, card=card)
    want = report["n_layer"] * report["verify_rounds"]
    if report["chunk_kernel_launches"] == 0 or report["chunk_kernel_launches"] != want:
        raise AssertionError(f"chunk launches {report['chunk_kernel_launches']} != n_layer x "
                             f"verify rounds = {want}")
    if not np.isfinite(report["val_loss"]):
        raise AssertionError("the trained model's validation loss is not finite")
    check_spec_trained_kernels(report, peak_bw, peak_ops)
    return report


# --- phase 17: LoRA efficiency at 12L8H d512 ------------------------------------


def phase_lora_d512(card: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="smoke_lora_") as tmp:
        args = bench_lora.parser().parse_args(["--workdir", tmp])
        r = bench_lora.run_d512_efficiency(args, "cuda")
    full, lora = r["full_finetune"], r["lora"]
    log("lora_d512", protocol=r["protocol"], adapter_params=r["adapter_params"],
        checkpoint_bytes=r["checkpoint_bytes"], full_finetune=full, lora=lora,
        opt_state_ratio=r["opt_state_ratio"], step_time_ratio=r["step_time_ratio"],
        roundtrip_max_abs_err=r["roundtrip_max_abs_err"], card=card)
    n_layer = bench_lora.D512_MODEL["n_layer"]
    want_adapters = n_layer * 4 * 2 * 512 * args.d512_rank  # q, k, v, proj: a and b
    if lora["trainable_params"] != r["adapter_params"] or r["adapter_params"] != want_adapters:
        raise AssertionError(f"LoRA trains {lora['trainable_params']} parameters, the "
                             f"adapters hold {r['adapter_params']}, want {want_adapters}")
    if any(row["flash_fwd_launches_per_step"] != n_layer for row in (full, lora)):
        raise AssertionError("a d512 step did not launch the flash forward once per layer")
    if not (r["opt_state_ratio"] < 0.02 and np.isfinite([full["loss"], lora["loss"]]).all()):
        raise AssertionError(f"moment ratio {r['opt_state_ratio']}, losses {full['loss']}, "
                             f"{lora['loss']}")
    return r


# --- phase 18: LoRA fine-tuning at d512 through the CLI ---------------------------

FINETUNE_CONFIG = Path(__file__).resolve().parent / "configs" / "finetune_lora_r8_d512.yaml"
FINETUNE_GROUPS_PER_EPOCH = 2
FINETUNE_VAL_WINDOWS = 32
FINETUNE_REQUESTS = 64
# merged against unmerged float32 forwards: W + s a b folded once against
# x W + s (x a) b, the same float32 products summed in another order
# (~1e-7 relative each); a missing or doubled adapter moves logits by far more
FINETUNE_MERGE_RTOL = 1e-5


def finetune_yaml(workdir: Path, name: str, drop_lora: bool = False, **overrides) -> Path:
    """``configs/finetune_lora_r8_d512.yaml`` (read, never edited) with the
    phase's data paths, epochs and run id, written into ``workdir``; each
    override is logged. ``drop_lora`` leaves out the ``lora_*`` keys (the
    base pretraining)."""
    import yaml

    cfg = yaml.safe_load(FINETUNE_CONFIG.read_text())
    if drop_lora:
        cfg = {k: v for k, v in cfg.items() if not k.startswith("lora_")}
    overrides = dict(train_npz=str(workdir / "train.npz"), val_npz=str(workdir / "val.npz"),
                     run_id=name, **overrides)
    log("finetune_config", config=name, source=str(FINETUNE_CONFIG.name),
        dropped_lora_keys=drop_lora,
        overrides={k: {"recipe": cfg.get(k), "here": v} for k, v in overrides.items()})
    cfg.update(overrides)
    path = workdir / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def serve_tokens(model, cfg, reqs, **engine) -> tuple[list, ServingEngine]:
    eng = ServingEngine(model, cfg, device="cuda", **engine)
    rids = [eng.submit(p, b, temperature=t) for p, b, t in reqs]
    results = eng.run()
    return [results[r].tokens for r in rids], eng


def phase_finetune(card: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="smoke_finetune_") as tmp:
        tmp = Path(tmp)
        batch, gacc = 8, 16  # the recipe's
        packed_corpus(tmp, FINETUNE_GROUPS_PER_EPOCH * batch * gacc, FINETUNE_VAL_WINDOWS)
        runs = tmp / "runs"
        # few steps here: warm up over one step, schedule over the 2 epochs
        short = dict(warmup_steps=1, scheduler_total_steps=2 * FINETUNE_GROUPS_PER_EPOCH)
        base_cfg = finetune_yaml(tmp, "smoke-base", drop_lora=True, epochs=1, **short)
        lora_cfg = finetune_yaml(tmp, "smoke-lora", epochs=1, **short)
        straight_cfg = finetune_yaml(tmp, "smoke-lora-straight", epochs=2, **short)
        base_last = runs / "smoke-base" / "checkpoints" / "last.npz"
        lora_last = runs / "smoke-lora" / "checkpoints" / "last.npz"
        t0 = time.perf_counter()
        rc_base = train_cli(["--config", str(base_cfg), "--run_root", str(runs)])
        base_s = time.perf_counter() - t0
        lora_argv = ["--config", str(lora_cfg), "--run_root", str(runs),
                     "--transfer_from", str(base_last)]
        for w in FLASH_WRAPPERS:
            w.launches = 0  # the fine-tuning path's runs only: one epoch and its resume
        t0 = time.perf_counter()
        rc_lora = train_cli(lora_argv)
        lora_s = time.perf_counter() - t0
        lora_cfg.write_text(lora_cfg.read_text().replace("epochs: 1", "epochs: 2"))
        rc_resume = train_cli(lora_argv + ["--resume", str(lora_last)])
        launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
        rc_straight = train_cli(["--config", str(straight_cfg), "--run_root", str(runs),
                                 "--transfer_from", str(base_last)])
        merged_path = tmp / "merged.npz"
        rc_merge = merge_cli([str(lora_last), str(merged_path)])
        base = load_checkpoint(base_last)
        tuned = load_checkpoint(lora_last)
        straight = load_checkpoint(runs / "smoke-lora-straight" / "checkpoints" / "last.npz")
        merged = load_checkpoint(merged_path)
        lora_meta = json.loads((runs / "smoke-lora" / "checkpoints" / "meta.json").read_text())
        val = np.load(tmp / "val.npz")["X"][:8]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    base_leaves, tuned_leaves = dict(leaves(base["model"])), dict(leaves(tuned["model"]))
    frozen_moved = [p for p, v in base_leaves.items() if not np.array_equal(tuned_leaves[p], v)]
    adapters = {p: v for p, v in tuned_leaves.items() if "lora_" in p}
    state = tuned["optimizer"]["state"]
    state_names = sorted(state)
    not_adapter = [n for n in state_names if "lora_a" not in n and "lora_b" not in n]
    moment_elements = int(sum(np.size(s["exp_avg"]) for s in state.values()))
    trainable = lora_lib.lora_param_count(tuned["model"])
    straight_leaves = dict(leaves(straight["model"]))
    resume_diff = max(float(np.abs(straight_leaves[p] - v).max()) for p, v in tuned_leaves.items())

    # merged against unmerged, float32 on the card
    mcfg = CodonGPTConfig.from_run_config(dict(tuned["cfg"]))
    f32 = mcfg.replace(compute_dtype="float32", dropout=0.0)
    unmerged_model = params_from_jax(tuned["model"], f32, "cuda")
    merged_model = params_from_jax(merged["model"], f32, "cuda")
    x = torch.from_numpy(val).cuda().long()
    with torch.no_grad():
        want = model_forward(unmerged_model, f32, x)[0].float()
        got = model_forward(merged_model, f32, x)[0].float()
    merge_err = float((got - want).abs().max()) / float(want.abs().max())
    rng = np.random.default_rng(3)
    greedy = [(p, min(b, 64), 0.0) for p, b, _ in build_requests(rng, 16)]
    engine = dict(slots=16, max_seq_len=256, steps_per_sync=16)
    tok_unmerged, _ = serve_tokens(unmerged_model, f32, greedy, **engine)
    tok_merged, _ = serve_tokens(merged_model, f32, greedy, **engine)
    del unmerged_model, merged_model

    # the main path's serve: the merged checkpoint in bf16, as users serve it
    scfg = mcfg.replace(dropout=0.0)
    serve_model = params_from_jax(merged["model"], scfg, "cuda")
    reqs = build_requests(np.random.default_rng(4), FINETUNE_REQUESTS)
    da.decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served, eng = serve_tokens(serve_model, scfg, reqs, **ENGINE)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    decode_launches = da.decode_attention.launches
    steps = eng.stats()["decode_steps"]
    delivered = sum(len(t) for t in served)
    G, L = gacc, mcfg.n_layer
    groups = 2 * FINETUNE_GROUPS_PER_EPOCH
    val_mb = FINETUNE_VAL_WINDOWS // batch
    want_bwd = G * L * groups
    want_fwd = want_bwd + L * val_mb * 2
    out = dict(model="12L8H d512 bf16 fused_qkv flash, LoRA r8 attn, lora_only",
               rc=[rc_base, rc_lora, rc_resume, rc_straight, rc_merge],
               base_run_s=base_s, lora_epoch_s=lora_s,
               lora_val_loss=lora_meta.get("last_val_loss"),
               frozen_leaves=len(base_leaves), frozen_moved=frozen_moved,
               adapter_leaves=len(adapters),
               adapter_max_abs={p: float(np.abs(v).max()) for p, v in adapters.items()
                                if p.endswith("lora_b")},
               optimizer_state_tensors=len(state_names), optimizer_state_not_adapter=not_adapter,
               moment_elements=moment_elements, lora_param_count=trainable,
               resume_vs_straight_max_abs_diff=resume_diff,
               resume_val_loss=float(tuned["val_loss"]),
               straight_val_loss=float(straight["val_loss"]),
               merged_vs_unmerged_rel_err=merge_err, merge_tol=FINETUNE_MERGE_RTOL,
               f32_greedy_tokens_equal=tok_unmerged == tok_merged,
               serve_requests=len(reqs), serve_delivered_tokens=delivered, serve_s=serve_s,
               serve_tokens_per_s=delivered / serve_s, serve_decode_steps=steps,
               decode_launches=decode_launches, flash_launches=launches,
               want_fwd=want_fwd, want_bwd=want_bwd, card=card)
    log("finetune", **out)
    if any(out["rc"]) or frozen_moved or not_adapter or not adapters:
        raise AssertionError("the fine-tuning runs, the frozen weights or the optimizer "
                             "state are wrong")
    if moment_elements != trainable or trainable != 393_216:
        raise AssertionError(f"{moment_elements} moment elements, {trainable} adapter "
                             "parameters, want 393216")
    if not all(v > 0 for v in out["adapter_max_abs"].values()):
        raise AssertionError("an adapter did not train")
    if resume_diff != 0.0 or out["resume_val_loss"] != out["straight_val_loss"]:
        raise AssertionError(f"the resumed run differs from the straight one ({resume_diff})")
    if merge_err > FINETUNE_MERGE_RTOL or tok_unmerged != tok_merged:
        raise AssertionError(f"merged and unmerged models differ ({merge_err})")
    if decode_launches == 0 or decode_launches != L * steps:
        raise AssertionError(f"decode launches {decode_launches} != n_layer x decode steps "
                             f"({L} x {steps})")
    if (launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] != want_bwd
            or launches["flash_bwd_dkv"] != want_bwd):
        raise AssertionError(f"flash launches {launches}: want fwd {want_fwd}, "
                             f"dq/dkv {want_bwd}")
    # the decode kernel at the shapes this serve ran it at (heads of 64, G 1)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for cdt, lengths in ((torch.bfloat16, "serve"), (torch.bfloat16, "random")):
        check_decode_case(gen, "finetune_kernel", f"decode_d512_{lengths}", L,
                          ENGINE["slots"], ENGINE["max_seq_len"], mcfg.kv_heads, 1,
                          mcfg.head_dim, cdt, torch.bfloat16, lengths)
    return {"flash": launches, "decode": decode_launches}


# --- phase 19: the primary training contract's step, with and without remat ------

REMAT_TIMED_GROUPS = 3
# the same kernels on the same inputs in the same order: the recomputed
# block gives the stored activations' values, so loss and gradients agree up
# to the order of the library's float32 sums; a recompute that drew other
# dropout masks or seeds moves the gradients by order 1
REMAT_GRAD_RTOL = 1e-5


def phase_remat_contract(card: str) -> dict:
    expected = contracts.expected_primary_config("primary", "genome", 1337)
    header = {"schema": contracts.SCHEMA_NAME, "version": contracts.SCHEMA_VERSION,
              "release": contracts.RELEASE, "dataset_freeze_id": contracts.DATASET_FREEZE_ID,
              "role": "primary", "protocol": "genome",
              "dataset_id": contracts.DATASETS["genome"]["dataset_id"]}
    bound = contracts.validate_primary_training_config(
        dict(expected, seed=1337, primary_training_contract=header))
    mcfg = CodonGPTConfig.from_run_config(dict(expected))
    if not (mcfg.use_checkpoint and mcfg.attention_impl == "flash"):
        raise AssertionError("the contract does not pin remat and flash attention")
    run_cfg = {k: expected[k] for k in ("lr", "lr_embedding", "min_lr", "weight_decay",
                                        "scheduler", "warmup_steps", "optimizer")}
    G, B, T = expected["grad_accum_steps"], expected["batch_size"], expected["block_size"]
    batches = [train_main.make_batch(s, "cuda", groups=G, batch=B, length=T)
               for s in range(2)]
    rows = {}
    for remat in (True, False):
        cfg = mcfg.replace(use_checkpoint=remat)
        torch.manual_seed(1337)
        model = CodonGPT(cfg).to("cuda").train()
        bundle = build_optimizer(run_cfg, model, expected["scheduler_total_steps"])
        step = make_train_step(cfg, LossConfig(label_smoothing=expected["label_smoothing"]))
        gen = torch.Generator(device="cuda").manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in FLASH_WRAPPERS:
            w.launches = 0  # one group of the contract's step
        m = step(model, bundle, batches[0], gen, 1.0)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        seconds, metrics = train_main.run_groups(model, bundle, step, batches, gen,
                                                 REMAT_TIMED_GROUPS)
        rows[remat] = dict(loss=float(m["total_loss_sum"]), applied=bool(m["applied"]),
                           launches=launches, peak_mem_bytes=peak, grads=grads,
                           ms_per_group=seconds * 1e3 / REMAT_TIMED_GROUPS,
                           applied_all=all(bool(x["applied"]) for x in metrics))
        del model, bundle
    on, off = rows[True], rows[False]
    gmax = max(float(g.abs().max()) for g in off["grads"].values())
    grad_err = max(float((on["grads"][n] - g).abs().max()) / max(float(g.abs().max()),
                                                                  1e-3 * gmax)
                   for n, g in off["grads"].items())
    loss_err = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    L = mcfg.n_layer
    out = dict(contract=bound["run_id"], model="10L8H d384 bf16 flash, dropout 0.1",
               group_shape=[G, B, T], loss_remat=on["loss"], loss_plain=off["loss"],
               loss_rel_err=loss_err, grad_rel_err=grad_err, grad_tol=REMAT_GRAD_RTOL,
               launches_remat=on["launches"], launches_plain=off["launches"],
               peak_mem_gib_remat=on["peak_mem_bytes"] / 2**30,
               peak_mem_gib_plain=off["peak_mem_bytes"] / 2**30,
               ms_per_group_remat=on["ms_per_group"], ms_per_group_plain=off["ms_per_group"],
               nonpad_tokens_per_group=int((batches[0]["y"] != 0).sum()), card=card)
    log("remat_contract", **out)
    if not (on["applied"] and off["applied"] and on["applied_all"] and off["applied_all"]):
        raise AssertionError("a contract group was not applied")
    if loss_err > REMAT_GRAD_RTOL or grad_err > REMAT_GRAD_RTOL:
        raise AssertionError(f"remat changes the step: loss {loss_err}, grads {grad_err}")
    want = {True: (2 * L * G, L * G), False: (L * G, L * G)}
    for remat, row in rows.items():
        fwd, bwd = want[remat]
        got = row["launches"]
        if (got["flash_fwd"], got["flash_bwd_dq"], got["flash_bwd_dkv"]) != (fwd, bwd, bwd):
            raise AssertionError(f"remat={remat}: flash launches {got}, want fwd {fwd}, "
                                 f"dq/dkv {bwd}")
    if not on["peak_mem_bytes"] < off["peak_mem_bytes"]:
        raise AssertionError("remat did not lower the step's peak memory")
    return {"remat": on["launches"], "plain": off["launches"]}


# --- phase 20: weight-only int8 serving ------------------------------------------

INT8_BLOCK_LINEAR_BYTES = 17_694_720  # 10 x (qkv + proj + fc + proj) weights at d384, int8

# tolerance of the full-window NLL on the card against the CPU, both float32
# with TF32 off: the same weights, the same batches and the same float32
# products summed in another order (the flash kernel's SIMT float32 path
# against its plain version, cuBLAS against the CPU's GEMM), ~1e-6 relative
# on the mean; a masking, windowing or segment fault in the kernel, or a
# wrong microbatch, moves the mean NLL of a trained model by far more
SCORE_NLL_RTOL = 1e-4
SCORE_CPU_WINDOWS = 8  # validation windows of 512 run on both devices


def block_linear_bytes(model) -> int:
    """Bytes of the block linears' weights (dense float32 or int8 ``w_q``)."""
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if n.startswith("blocks.") and n.endswith(("weight", "w_q"))
               and ".ln" not in n)


def model_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def int8_greedy_parity() -> dict:
    """A 2-layer float32 model with int8 block linears serves the same greedy
    tokens on the card (decode kernel) as on the CPU (plain version), with a
    bf16 and an int8 cache."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CodonGPTConfig(**dict(MAIN, n_layer=2, block_size=256, compute_dtype="float32"))
    torch.manual_seed(5)
    cpu_model = quantize_params(CodonGPT(cfg).eval())
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(5)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, n)], 24) for n in (9, 23, 40, 17)]
    reqs[1][0][7] = 3  # a <SEP> inside one prompt
    out = {}
    for kv_quant in (False, True):
        before = da.decode_attention.launches
        on_card = serve_tokens(gpu_model, cfg, [(p, n, 0.0) for p, n in reqs], slots=4,
                               max_seq_len=128, steps_per_sync=8, kv_quant=kv_quant)[0]
        launched = da.decode_attention.launches - before
        eng = ServingEngine(cpu_model, cfg, slots=4, max_seq_len=128, steps_per_sync=8,
                            kv_quant=kv_quant, device="cpu")
        rids = [eng.submit(p, n) for p, n in reqs]
        res = eng.run()
        on_cpu = [res[r].tokens for r in rids]
        out[kv_quant] = dict(identical_tokens=on_card == on_cpu, kernel_launches=launched)
        if on_card != on_cpu or launched == 0:
            raise AssertionError(f"int8-weight greedy tokens differ between the card and the "
                                 f"CPU (kv_quant={kv_quant})")
    return out


def phase_int8_serve(served: dict, card: str) -> dict:
    """The serving main path with weight-only int8 block linears: the dense
    model of phase 4, quantized by ``quantize_params``, drains the same 128
    requests with a bf16 and an int8 cache; then a speculative drain, the
    card-vs-CPU greedy check, and ``benchmark_serving --int8_weights`` (a
    closed-loop and an open-loop run)."""
    dense, cfg = served["model"], served["cfg"]
    model = quantize_params(copy.deepcopy(dense))
    bytes_row = dict(dense_model_bytes=model_bytes(dense), int8_model_bytes=model_bytes(model),
                     dense_block_linear_bytes=block_linear_bytes(dense),
                     int8_block_linear_bytes=block_linear_bytes(model))
    if bytes_row["int8_block_linear_bytes"] != INT8_BLOCK_LINEAR_BYTES or (
            4 * INT8_BLOCK_LINEAR_BYTES != bytes_row["dense_block_linear_bytes"]):
        raise AssertionError(f"block-linear bytes {bytes_row}")
    rng = np.random.default_rng(0)
    warm = build_requests(rng, 8)
    reqs = build_requests(rng, REQUESTS)  # the requests of phase_serve
    drain(model, cfg, warm, False)
    counts = {}
    for kv_quant in (False, True):
        # dense, int8, int8, dense on the same requests: the host drifts
        # within a call, so the pair means are compared
        runs = {"dense": [], "int8": []}  # (seconds, delivered tokens) of each drain
        for name in ("dense", "int8", "int8", "dense"):
            torch.cuda.reset_peak_memory_stats()
            da.decode_attention.launches = 0  # this drain's count only
            results, seconds, eng = drain(model if name == "int8" else dense, cfg, reqs,
                                          kv_quant)
            launches = da.decode_attention.launches
            steps = eng.stats()["decode_steps"]
            runs[name].append((seconds, sum(len(r.tokens) for r in results.values())))
            if launches == 0 or launches != cfg.n_layer * steps:
                raise AssertionError(f"{name}: kernel launches {launches} != n_layer x "
                                     f"decode steps ({cfg.n_layer} x {steps})")
            if name == "int8":
                counts[kv_quant] = launches
        tps = {k: [d / t for t, d in v] for k, v in runs.items()}
        mean = {k: sum(v) / len(v) for k, v in tps.items()}
        log("int8_serve", model="10L8H d384 bf16 fused_qkv, int8 block linears",
            kv_quant=kv_quant, requests=len(reqs), order="dense, int8, int8, dense",
            int8_tokens_per_s=tps["int8"], dense_tokens_per_s=tps["dense"],
            int8_over_dense=mean["int8"] / mean["dense"],
            phase4_dense_delivered_tokens_per_s=served["tokens_per_s"][kv_quant],
            decode_steps=steps, kernel_launches=counts[kv_quant],
            ms_per_decode_step_int8=[t * 1e3 / steps for t, _ in runs["int8"]],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, **bytes_row, card=card)

    spec = dict(speculative_k=SPECULATIVE_K, draft_table=fit_draft_table(model, cfg))
    da.decode_attention_chunk.launches = 0
    da.decode_attention.launches = 0
    results, seconds, eng = drain(model, cfg, reqs, False, **spec)
    rounds = eng.stats()["verify_rounds"]
    chunk_launches = da.decode_attention_chunk.launches
    delivered = sum(len(r.tokens) for r in results.values())
    log("int8_spec_serve", speculative_k=SPECULATIVE_K, delivered_tokens=delivered,
        seconds=seconds, delivered_tokens_per_s=delivered / seconds, verify_rounds=rounds,
        accept_rate=eng.stats()["speculative_accept_rate"],
        chunk_kernel_launches=chunk_launches,
        decode_kernel_launches=da.decode_attention.launches, card=card)
    if chunk_launches == 0 or chunk_launches != cfg.n_layer * rounds:
        raise AssertionError(f"chunk launches {chunk_launches} != n_layer x rounds "
                             f"({cfg.n_layer} x {rounds})")
    del model, eng, results

    parity = int8_greedy_parity()
    log("int8_parity", model="2L8H d384 f32, int8 block linears", **{
        f"kv_quant_{k}": v for k, v in parity.items()})

    reports = {}
    for name, argv in (("closed_loop", ["--int8_weights", "--repeats", "1"]),
                       ("open_loop", ["--int8_weights", "--arrival_rate", "40",
                                      "--requests", "128"])):
        t0 = time.perf_counter()
        reports[name] = bench_serving.run(bench_serving.parser().parse_args(argv))
        print(json.dumps({k: v for k, v in reports[name].items() if k != "ttft_ms"}),
              flush=True)
        log("int8_benchmark_serving", protocol=name, seconds=time.perf_counter() - t0,
            value=reports[name]["value"], unit=reports[name]["unit"], card=card)
    if len(reports["open_loop"]["ttft_ms"]) != 128:
        raise AssertionError("the open-loop run did not time every request")
    return {"launches": counts[False], "launches_int8_cache": counts[True]}


# --- phase 21: generation from a trained run -------------------------------------

# the info keys of each generator, as genomics_lm_tpu/generation/constrained.py
# writes them
_CONSTRAINED_INFO = {"protocol", "guidance_components", "had_terminal_stop", "early_stop",
                     "hit_hard_cap", "target_codons", "generated_codons",
                     "termination_bias_enabled", "termination_bias_steps",
                     "termination_bias_window", "last_termination_class", "cds_only",
                     "require_terminal_stop", "generated_tokens"}
INFO_SCHEMA = {
    "raw": {"protocol", "cds_only", "require_terminal_stop", "guidance_components",
            "had_terminal_stop", "early_stop", "hit_hard_cap", "generated_codons",
            "generated_tokens", "max_new_tokens", "stop_reason"},
    "constrained": _CONSTRAINED_INFO,
    "red": _CONSTRAINED_INFO | {"attempts", "total_tokens_red"},
    "critic_guided": {"protocol", "guidance_components", "had_terminal_stop", "early_stop",
                      "hit_hard_cap", "target_codons", "generated_codons", "cds_only",
                      "require_terminal_stop", "generated_tokens"},
}
INFO_SCHEMA["synonymous"] = INFO_SCHEMA["critic_guided"]
GENERATE_PROTEIN = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRV"  # 40 residues


def critic_score(aa_seqs) -> np.ndarray:
    """A numpy critic for the smoke: hydrophobic residues up, prolines down."""
    return np.asarray([sum(a in "AILMFVW" for a in s) / max(1, len(s)) - 0.5 * s.count("P")
                       for s in aa_seqs], np.float64)


class _Timed:
    """Wraps ``module.name`` for the duration of a ``with``: counts its calls
    and sums their seconds (nested timers included); ``record`` keeps a value
    computed from each call's arguments. On ``generation/decode.py``'s
    ``decode_step`` and ``forward``, which ``CachedDecoder`` reaches by their
    module names, it counts the cached steps and the uncached forwards that
    the kernels' launch counts are checked against."""

    def __init__(self, module, name: str, record=None):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.record, self.calls, self.seconds, self.records = record, 0, 0.0, []

    def __enter__(self):
        def timed(*a, **k):
            self.calls += 1
            if self.record is not None:
                self.records.append(self.record(*a, **k))
            t0 = time.perf_counter()
            try:
                return self.fn(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_generate(trained: dict, card: str, peak_bw, peak_ops) -> dict:
    """Every generator of ``generation/constrained.py`` on the run phase 15
    wrote (10L8H d384, bf16, flash), loaded by ``load_codon_model``, from one
    seed; then the CLIs on that run. The decode kernel's launches must equal
    n_layer x cached decode steps, the flash forward's n_layer x uncached
    forwards (the clip-and-recompute path of a context over the block)."""
    run_dir = trained["run_dir"]
    model, cfg, itos, stoi = load_codon_model(run_dir, device="cuda")
    dec = CachedDecoder(model, cfg.replace(dropout=0.0))
    rng = np.random.default_rng(0)
    ctx = [stoi["<BOS_CDS>"], stoi["ATG"]]
    long_ctx = ctx + [int(t) for t in rng.integers(4, 68, cfg.block_size + 8)]
    term = bool(cfg.termination_aux)
    hard_cap = 60
    da.decode_attention.launches = 0  # the generators' run only
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    with _Timed(decode_mod, "decode_step") as steps, _Timed(decode_mod, "forward") as uncached:
        out = {
            "raw": gc.generate_model_raw(dec, ctx, stoi, itos, 48, rng=rng),
            "raw_long_context": gc.generate_model_raw(dec, long_ctx, stoi, itos, 4, rng=rng),
            "constrained": gc.generate_cds_constrained(
                dec, ctx, stoi, itos, target_codons=40, hard_cap=hard_cap,
                termination_bias_enabled=term, termination_stop_bias=2.0 if term else 0.0,
                termination_bias_window=8, rng=rng),
            "red": gc.generate_cds_red(dec, ctx, stoi, itos, target_codons=24,
                                       hard_cap=hard_cap, max_attempts=3, rng=rng),
            "critic_guided": gc.generate_cds_critic_guided(
                dec, critic_score, ctx, stoi, itos, target_codons=32, hard_cap=hard_cap,
                rng=rng),
            "synonymous": gc.generate_cds_synonymous(dec, ctx, stoi, itos, GENERATE_PROTEIN,
                                                     score_fn=critic_score, rng=rng),
        }
        solved, remaining, spent = gc.batch_red_sampler(
            dec, [ctx, ctx + [stoi["GCT"]], ctx + [stoi["AAA"]], [stoi["<BOS_CDS>"]]],
            stoi, itos, target_codons=16, hard_cap=32, global_token_budget=200, rng=rng)
    seconds = time.perf_counter() - t0
    decode_launches, flash_launches = da.decode_attention.launches, fa.flash_fwd.launches
    L = cfg.n_layer
    problems = []
    for name, (ids, info) in out.items():
        schema = INFO_SCHEMA[name.removesuffix("_long_context")]
        if set(info) != schema:
            problems.append(f"{name}: info keys {sorted(set(info) ^ schema)}")
        start = len(long_ctx) if name == "raw_long_context" else len(ctx)
        new = ids[start:]
        if not all(0 <= t < len(itos) for t in new):
            problems.append(f"{name}: a token outside the vocabulary")
        if name not in ("raw", "raw_long_context", "synonymous"):
            if not all(gc._is_codon(itos[t]) for t in new) or info["generated_codons"] > hard_cap:
                problems.append(f"{name}: a non-codon or more than {hard_cap} codons")
    syn_ids, _ = out["synonymous"]
    codons = [itos[t] for t in syn_ids[len(ctx):] if gc._is_codon(itos[t])]
    translated = translate_codons_to_aa(codons[:-1])
    if translated != GENERATE_PROTEIN or codons[-1] not in gc.STOP_CODONS:
        problems.append(f"synonymous CDS translates to {translated}")
    if spent > 200 + 32 or set(solved) | set(remaining) != {0, 1, 2, 3}:
        problems.append(f"batch ReD spent {spent} of 200 (+ one attempt of 32)")
    row = dict(run=str(run_dir.name), model="10L8H d384 bf16 fused_qkv flash (phase 15's run)",
               termination_head=term, seconds=seconds,
               generated={k: info["generated_codons"] for k, (_, info) in out.items()},
               stops={k: info["had_terminal_stop"] for k, (_, info) in out.items()},
               red_attempts=out["red"][1]["attempts"], batch_red_solved=sorted(solved),
               batch_red_tokens=spent, synonymous_protein=translated,
               cached_decode_steps=steps.calls, uncached_forwards=uncached.calls,
               decode_launches=decode_launches, flash_fwd_launches=flash_launches,
               problems=problems, card=card)
    log("generate", **row)
    if problems:
        raise AssertionError("; ".join(problems))
    if decode_launches == 0 or decode_launches != L * steps.calls:
        raise AssertionError(f"decode launches {decode_launches} != n_layer x cached steps "
                             f"({L} x {steps.calls})")
    if flash_launches == 0 or flash_launches != L * uncached.calls:
        raise AssertionError(f"flash launches {flash_launches} != n_layer x uncached "
                             f"forwards ({L} x {uncached.calls})")

    # the CLIs on the same run
    cli = {}
    for name, fn, argv in (
            ("sample", sample_cli, [str(run_dir), "--max_new_tokens", "24"]),
            ("query_next", query_cli, [str(run_dir), "--mode", "next", "--dna", "ATGGCT"]),
            ("query_generate", query_cli, [str(run_dir), "--mode", "generate", "--dna",
                                           "ATGGCT", "--target_codons", "16"]),
            ("query_score", query_cli, [str(run_dir), "--mode", "score", "--dna",
                                        "ATGGCTAAACCCGGGTTTTAA"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv + ["--device", "cuda"])
        text = buf.getvalue()
        cli[name] = text
        if rc != 0 or not text.strip():
            raise AssertionError(f"{name} exited {rc} with {text[:200]!r}")
    nxt = json.loads(cli["query_next"])["next"]
    gen_reply = json.loads(cli["query_generate"])
    score = json.loads(cli["query_score"])
    if not (len(nxt) == 10 and abs(sum(r["prob"] for r in nxt)) <= 1.0 + 1e-6
            and np.isfinite(score["total_logprob"]) and score["tokens"] == 7
            and set(gen_reply["info"]) == INFO_SCHEMA["constrained"]):
        raise AssertionError(f"query_model replies: {cli}")
    server = serve_build(serve_parser().parse_args(
        ["--run", str(run_dir), "--port", "0", "--int8_weights", "--slots", "8",
         "--max_seq_len", "256", "--device", "cuda"]))
    server.start()
    try:
        conn = http.client.HTTPConnection(*server.address, timeout=120)
        conn.request("POST", "/generate", json.dumps({"dna": "ATGGCTAAA",
                                                      "max_new_tokens": 16}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = json.loads(resp.read())
        conn.close()
    finally:
        server.stop()
    if resp.status != 200 or len(reply["tokens"]) != 16:
        raise AssertionError(f"serve_model --int8_weights answered {resp.status}: {reply}")
    log("generate_cli", sample=cli["sample"].strip().splitlines()[-1],
        query_next_top=nxt[0], query_generate_codons=gen_reply["info"]["generated_codons"],
        query_score=score, serve_int8_reply_tokens=len(reply["tokens"]), card=card)

    # the decode kernel at CachedDecoder's shape: one sequence over a
    # whole-block cache (its prefill's), at a random length, at a serving
    # request's length (``serve_mask``: prompt plus part of its budget), and
    # with every position live; the last two timed
    gen = torch.Generator(device="cuda").manual_seed(13)
    S, G = cfg.block_size, cfg.n_head // cfg.kv_heads
    b1 = {}
    for lengths in ("random", "serve", "full"):
        name = f"b1_{lengths}"
        q, k, v, mask, ks, vs, err, nan_err = check_decode_case(
            gen, "generate_kernel", name, L, 1, S, cfg.kv_heads, G, cfg.head_dim,
            torch.bfloat16, torch.bfloat16, lengths)
        if lengths != "random":
            b1[lengths] = time_decode_case(name, q, k, v, mask, ks, vs, cfg.kv_heads, G,
                                           da.decode_attention, peak_bw, peak_ops, err,
                                           nan_err, "generate_kernel_time")
    return {"decode": decode_launches, "flash": flash_launches, "b1": b1["serve"],
            "b1_full": b1["full"], "model": model, "cfg": cfg}


# --- phase 22: perplexity, context ablation and mutation scores ------------------


def check_flash_forward(gen, phase, name, B, T, window, peak_bw, peak_ops,
                        H=MAIN["n_head"], D=MAIN["n_embd"] // MAIN["n_head"], seg=None,
                        dtype=torch.bfloat16) -> dict:
    """The flash forward at inference (bf16 by default, no dropout, H heads
    of D, by default the serving model's 8 of 48) against its plain version,
    then its time beside its bound, the plain version's and SDPA's forward
    with the dense mask. ``seg``: the (B, T) segment ids of real windows;
    by default a <SEP> every 97th token."""
    q, k, v, seg97, seed, fcfg = flash_case(gen, B, H, H, T, T, D, dtype, window, 0.0)
    seg = seg97 if seg is None else seg.to(device=q.device, dtype=torch.int32).contiguous()
    out, lse = fa.flash_fwd(q, k, v, seg, seed, fcfg)
    want, want_lse = fa.flash_forward_reference(q, k, v, seg, seed, fcfg)
    torch.cuda.synchronize()
    errs, abs_errs = {}, {}
    for key, got, ref in (("out", out, want), ("lse", lse, want_lse)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash {name}: non-finite {key}")
        abs_errs[key] = float((got.float() - ref.float()).abs().max())
        errs[key] = abs_errs[key] / max(1.0, float(ref.float().abs().max()))
    live = fa.flash_live_tiles(seg, T, T, True, window)
    tol = FLASH_TOL[dtype]
    if max(errs.values()) > tol:
        raise AssertionError(f"flash {name}: kernel disagrees with its plain version "
                             f"({errs} > {tol})")
    bounds, pairs = flash_bounds(q, k, seg, fcfg, peak_bw, peak_ops)
    dense = structure_mask(T, T, causal=True, window=window, segment_ids=seg,
                           device=q.device)
    timed = dict(ms=median_ms(lambda: fa.flash_fwd(q, k, v, seg, seed, fcfg), runs=15),
                 plain_ms=median_ms(lambda: fa.flash_forward_reference(q, k, v, seg, seed,
                                                                       fcfg), runs=5),
                 bound_ms=bounds["fwd"]["bound_ms"], bound_by=bounds["fwd"]["bound_by"],
                 library_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, attn_mask=dense), runs=15),
                 max_abs_err=max(abs_errs.values()))
    log(phase, case=name, shape=dict(B=B, Hq=H, T=T, D=D), dtype=str(dtype), window=window,
        segments="<SEP> every 97th" if seg is seg97 else "from the windows", rel_err=errs,
        tol=tol, tol_reason=FLASH_TOL_REASON, tiles_visited=int(live.sum()) * H,
        attended_pairs=pairs, bytes=bounds["fwd"]["bytes"], **timed,
        roofline_share=timed["bound_ms"] / timed["ms"])
    return timed


def phase_score(trained: dict, generated: dict, card: str, peak_bw, peak_ops) -> dict:
    """``evaluate_perplexity`` and ``context_ablation`` on the validation
    split of phase 15's run (64 windows of 512, one microbatch of 64 a
    window), ``score_mutations`` on a CDS longer than the block; the flash
    forward's launches equal n_layer x microbatches (and x windows of the
    sliding score). The full-window NLL and window 1's on the card against
    the CPU, both float32 from the same weights; then the flash forward at
    these shapes against its plain version, timed."""
    model, cfg = generated["model"], generated["cfg"]
    val = PackedDataset(str(trained["val_npz"]))
    L = cfg.n_layer
    batch = 64
    fa.flash_fwd.launches = 0  # the scoring path's run only
    t0 = time.perf_counter()
    ablation = ppl.context_ablation(model, cfg, val, batch_size=batch)
    ablation_s = time.perf_counter() - t0
    microbatches = 4 * -(-len(val) // batch)
    ablation_launches = fa.flash_fwd.launches
    rng = np.random.default_rng(17)
    cds = "ATG" + "".join(rng.choice(list("ACGT"), 3 * (cfg.block_size + 80))) + "TAA"
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    rows = mut.score_mutations(model, cfg, cds)
    mutations_s = time.perf_counter() - t0
    mutation_launches = fa.flash_fwd.launches
    n_ids = len(mut.dna_to_ids(cds))
    windows = 1 + (n_ids - cfg.block_size)  # the first window, then one a position
    finite = all(np.isfinite(r["nll"]) for r in ablation.values()) and all(
        np.isfinite(r["wt_logp"]) for r in rows)

    # the card against the CPU, float32 (TF32 off), on the first windows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = cfg.replace(compute_dtype="float32", dropout=0.0)
    sub = trained["val_npz"].with_name("val_score_subset.npz")
    with np.load(trained["val_npz"]) as data:
        np.savez(sub, X=data["X"][:SCORE_CPU_WINDOWS], Y=data["Y"][:SCORE_CPU_WINDOWS])
    cpu_model = copy.deepcopy(model).cpu()
    compare = {}
    for window in (None, 1):
        on_card = ppl.evaluate_perplexity(model, f32, sub, batch_size=SCORE_CPU_WINDOWS,
                                          attention_window=window)["nll"]
        on_cpu = ppl.evaluate_perplexity(cpu_model, f32, sub, batch_size=SCORE_CPU_WINDOWS,
                                         attention_window=window)["nll"]
        compare["full" if window is None else str(window)] = dict(
            card=on_card, cpu=on_cpu, rel_err=abs(on_card - on_cpu) / abs(on_cpu))
    del cpu_model
    log("score", model="10L8H d384 bf16 flash (phase 15's run)", windows=len(val),
        microbatch=batch, ablation={k: dict(nll=r["nll"], perplexity=r["perplexity"],
                                            tokens=r["tokens"]) for k, r in ablation.items()},
        ablation_s=ablation_s, flash_fwd_launches=ablation_launches,
        want_launches=L * microbatches, mutation_codons=len(rows), mutation_windows=windows,
        mutations_s=mutations_s, mutation_flash_launches=mutation_launches,
        card_vs_cpu_f32=compare, tol=SCORE_NLL_RTOL, all_finite=finite, card=card)
    if not finite or len(rows) != n_ids - 1:
        raise AssertionError("a perplexity or mutation score is not finite, or rows missing")
    if ablation_launches != L * microbatches or mutation_launches != L * windows:
        raise AssertionError(f"flash launches {ablation_launches} and {mutation_launches}: "
                             f"want {L * microbatches} and {L * windows}")
    if any(c["rel_err"] > SCORE_NLL_RTOL for c in compare.values()):
        raise AssertionError(f"the card's NLL differs from the CPU's: {compare}")

    # the flash forward at these shapes against its plain version, timed
    gen = torch.Generator(device="cuda").manual_seed(19)
    inference = {}
    for window in (1, 2, 4, None):
        name = f"b{batch}_w{window or 'full'}"
        inference[name] = check_flash_forward(gen, "score_kernel", name, batch,
                                              cfg.block_size, window, peak_bw, peak_ops)
    for T in (cfg.block_size, 77):
        inference[f"b1_t{T}"] = check_flash_forward(gen, "score_kernel", f"b1_t{T}", 1, T,
                                                    None, peak_bw, peak_ops)
    return {"launches": ablation_launches, "launches_mutations": mutation_launches,
            "inference": inference}



# --- phases 23-28: the mixture-of-experts slice --------------------------------

MOE_CONFIG = Path(__file__).resolve().parent / "configs" / "stage2.6_moe_4e_top2_d512_ep2.yaml"
MOE_GROUPS_PER_EPOCH = 2
MOE_VAL_WINDOWS = 64
MOE_PARAMS, DENSE_PARAMS = 113_740_800, 38_126_592  # counted from JAX init's shapes
MOE_PARITY_CAPACITY = 0.5  # about half the choices drop: a wrong slot order shows
# a (token, rank) choice may flip between the card and the CPU only where the
# competing experts' probabilities lie within float32 rounding of each other
MOE_NEAR_TIE = 1e-6
EMBED_F32_ATOL = 1e-4
EMBED_WINDOWS = 64
MOE_CPU_WINDOWS = 2  # validation windows of 512 scored on both devices (12L d512 on the CPU)


def moe_yaml(workdir: Path, name: str, **overrides) -> Path:
    """``configs/stage2.6_moe_4e_top2_d512_ep2.yaml`` (read, never edited) with
    the phase's data paths, epochs, run id and schedule, written into
    ``workdir``; each override is logged."""
    import yaml

    cfg = yaml.safe_load(MOE_CONFIG.read_text())
    overrides = dict(train_npz=str(workdir / "train.npz"), val_npz=str(workdir / "val.npz"),
                     run_id=name, **overrides)
    log("moe_config", config=name, source=MOE_CONFIG.name,
        overrides={k: {"recipe": cfg.get(k), "here": v} for k, v in overrides.items()})
    cfg.update(overrides)
    path = workdir / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


@contextlib.contextmanager
def recorded_routes(keep: bool = False):
    """Collect the router loss of every ``moe_route`` call that computes one
    (or, with ``keep``, every call's whole result on the host) while the
    block runs."""
    routes, route = [], codon_gpt_mod.moe_route

    def record(*args, **kwargs):
        out = route(*args, **kwargs)
        if keep:
            routes.append({k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                           for k, v in out.items()})
        elif out["aux"] is not None:
            routes.append(out["aux"].detach())
        return out

    codon_gpt_mod.moe_route = record
    try:
        yield routes
    finally:
        codon_gpt_mod.moe_route = route


def tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def phase_moe_train(card: str, workdir: Path) -> dict:
    """The MoE config through the train CLI: 2 epochs of 2 groups and a resume
    to a third, beside a straight 3-epoch run; the run stays in ``workdir``."""
    runs = workdir / "runs"
    batch, gacc = 8, 16  # the config's
    packed_corpus(workdir, MOE_GROUPS_PER_EPOCH * batch * gacc, MOE_VAL_WINDOWS)
    short = dict(warmup_steps=1, scheduler_total_steps=3 * MOE_GROUPS_PER_EPOCH)
    cfg_path = moe_yaml(workdir, "smoke-moe", epochs=2, **short)
    straight_path = moe_yaml(workdir, "smoke-moe-straight", epochs=3, **short)
    run_dir = runs / "smoke-moe"
    last = run_dir / "checkpoints" / "last.npz"
    argv = ["--config", str(cfg_path), "--run_root", str(runs)]
    for w in FLASH_WRAPPERS:
        w.launches = 0  # the MoE path's runs only: 2 epochs and the resume
    torch.cuda.reset_peak_memory_stats()
    stdout = io.StringIO()
    with recorded_routes() as auxes, contextlib.redirect_stdout(stdout):
        t0 = time.perf_counter()
        rc = train_cli(argv)
        first_s = time.perf_counter() - t0
        cfg_path.write_text(cfg_path.read_text().replace("epochs: 2", "epochs: 3"))
        rc_resume = train_cli(argv + ["--resume", str(last)])
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    text = stdout.getvalue()
    sys.stdout.write("".join(line + "\n" for line in text.splitlines()
                             if line.startswith(("[epoch", "[timing]", "[model]"))))
    epoch_wall = [float(m) for m in re.findall(r"\[timing\] epoch \d+ wall_sec=([\d.]+)", text)]
    aux = torch.stack(auxes).float().cpu() if auxes else torch.zeros(0)
    rc_straight = train_cli(["--config", str(straight_path), "--run_root", str(runs)])

    payload = load_checkpoint(last)
    straight = load_checkpoint(runs / "smoke-moe-straight" / "checkpoints" / "last.npz")
    meta = json.loads((run_dir / "checkpoints" / "meta.json").read_text())
    rows = (run_dir / "scores" / "curves.csv").read_text().strip().splitlines()[1:]
    train_losses = [float(r.split(",")[1]) for r in rows]
    val_losses = [float(r.split(",")[2]) for r in rows]
    resumed, straight_leaves = dict(tree_leaves(payload["model"])), dict(
        tree_leaves(straight["model"]))
    resume_diff = max(float(np.abs(straight_leaves[p] - v).max()) for p, v in resumed.items())
    mcfg = CodonGPTConfig.from_run_config(dict(payload["cfg"], vocab_size=68))
    with torch.device("meta"):
        n_params = codon_gpt_mod.param_count(CodonGPT(mcfg))
        n_dense = codon_gpt_mod.param_count(CodonGPT(mcfg.replace(moe_experts=0)))
    router = tuple(payload["model"]["blocks"]["router"]["w"].shape)
    L, groups = mcfg.n_layer, int(payload["step"])
    val_mb = MOE_VAL_WINDOWS // batch
    want_bwd = gacc * L * groups
    want_fwd = want_bwd + L * val_mb * len(rows)
    out = dict(model="12L8H d512 bf16 fused_qkv flash, MoE 4 experts top-2 capacity 1.25",
               rc=[rc, rc_resume, rc_straight], param_count=n_params, dense_param_count=n_dense,
               meta_n_params=meta.get("n_params"), router_shape=router, groups=groups,
               train_losses=train_losses, val_losses=val_losses,
               moe_aux_calls=int(aux.numel()), moe_aux_min=float(aux.min()) if aux.numel() else None,
               moe_aux_max=float(aux.max()) if aux.numel() else None,
               moe_aux_finite=bool(torch.isfinite(aux).all()),
               resume_vs_straight_max_abs_diff=resume_diff,
               resume_val_loss=float(payload["val_loss"]),
               straight_val_loss=float(straight["val_loss"]),
               first_run_s=first_s, epoch_wall_s=epoch_wall,
               ms_per_group_with_validation=[1e3 * s / MOE_GROUPS_PER_EPOCH for s in epoch_wall],
               peak_mem_gib=meta["runtime_memory"]["device_peak_bytes"] / 2**30,
               flash_launches=launches, want_fwd=want_fwd, want_bwd=want_bwd, card=card)
    log("moe_train", **out)
    if any(out["rc"]) or len(rows) != 3 or groups != 3 * MOE_GROUPS_PER_EPOCH:
        raise AssertionError("the MoE runs or their artifacts are wrong")
    if n_params != MOE_PARAMS or n_dense != DENSE_PARAMS or meta.get("n_params") != MOE_PARAMS:
        raise AssertionError(f"param_count {n_params} (dense {n_dense}), want {MOE_PARAMS}")
    if router != (L, mcfg.n_embd, mcfg.moe_experts):
        raise AssertionError(f"router/w {router}")
    if not (np.isfinite(train_losses + val_losses).all() and out["moe_aux_finite"]
            and aux.numel() == want_fwd):  # one route a layer and forward, as flash
        raise AssertionError("a loss or a router loss is not finite, or routes are missing")
    if resume_diff != 0.0 or out["resume_val_loss"] != out["straight_val_loss"]:
        raise AssertionError(f"the resumed run differs from the straight one ({resume_diff})")
    if (launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] != want_bwd
            or launches["flash_bwd_dkv"] != want_bwd):
        raise AssertionError(f"flash launches {launches}: want fwd {want_fwd}, "
                             f"dq/dkv {want_bwd}")
    return {"launches": launches, "run_dir": run_dir, "val_npz": workdir / "val.npz"}


def phase_moe_parity() -> None:
    """One MoE group step in float32 on the card and on the CPU (capacity 0.5),
    and the dropped (token, rank) set of every layer on both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CodonGPTConfig(**dict(train_main.MOE_TRAIN, n_layer=2, dropout=0.0,
                                compute_dtype="float32",
                                moe_capacity_factor=MOE_PARITY_CAPACITY))
    torch.manual_seed(6)
    tree = params_to_jax(CodonGPT(cfg), cfg)
    run_cfg = dict(train_main.RUN_CFG, warmup_steps=0)
    batch = train_main.make_batch(9, "cpu", groups=2, batch=4)
    _parity_step("moe_capacity_0.5", cfg, tree, run_cfg, LossConfig(), batch, TRAIN_PARITY_TOL)
    routes = {}
    for dev in ("cuda", "cpu"):
        model = params_from_jax(tree, cfg, dev)
        with recorded_routes(keep=True) as got, torch.no_grad():
            model_forward(model, cfg, batch["x"][0].to(dev), train=True)
        routes[dev] = got
    flips, dropped = [], []
    for layer, (g, c) in enumerate(zip(routes["cuda"], routes["cpu"])):
        dropped.append(int((~c["keep"]).sum()))
        differ = (g["gate_idx"] != c["gate_idx"]) | (g["keep"] != c["keep"])
        for n, r in zip(*np.nonzero(differ.numpy())):
            p = c["probs"][n]
            pair = sorted({int(g["gate_idx"][n, r]), int(c["gate_idx"][n, r])})
            margin = float(abs(p[pair[0]] - p[pair[-1]])) if len(pair) == 2 else 0.0
            flips.append(dict(layer=layer, token=int(n), rank=int(r), margin=margin,
                              near_tie=len(pair) == 2 and margin <= MOE_NEAR_TIE))
    log("moe_parity", tokens=int(batch["x"][0].numel()), choices_per_layer=2 * int(
        batch["x"][0].numel()), capacity=routes["cpu"][0]["C"], dropped_per_layer=dropped,
        dropped_sets_equal=not flips, flips=flips[:20], near_tie_tol=MOE_NEAR_TIE)
    if not all(dropped) or any(not f["near_tie"] for f in flips):
        raise AssertionError(f"the card's routing differs from the CPU's: {flips[:5]}")


def moe_f32_serving(tree, cfg) -> dict:
    """A 2-layer float32 MoE model: greedy tokens on the card and the CPU,
    dense and int8 weights; one request alone against a full 64-slot drain."""
    rng = np.random.default_rng(7)
    reqs = [([1] + [int(t) for t in rng.integers(4, 68, int(n))], 24, 0.0)
            for n in rng.integers(8, 60, ENGINE["slots"])]
    out = {}
    for int8 in (False, True):
        toks = {}
        for dev in ("cuda", "cpu"):
            model = params_from_jax(tree, cfg, dev)
            if int8:
                quantize_params(model)
            eng = ServingEngine(model, cfg, slots=8, max_seq_len=128, steps_per_sync=8,
                                device=dev)
            rids = [eng.submit(p, b) for p, b, _ in reqs[:8]]
            res = eng.run()
            toks[dev] = [res[r].tokens for r in rids]
        out["int8" if int8 else "dense"] = toks["cuda"] == toks["cpu"]
    model = params_from_jax(tree, cfg, "cuda")
    full, _ = serve_tokens(model, cfg, reqs, slots=ENGINE["slots"], max_seq_len=128,
                           steps_per_sync=8)
    alone, _ = serve_tokens(model, cfg, reqs[5:6], slots=ENGINE["slots"], max_seq_len=128,
                            steps_per_sync=8)
    out["alone_equals_full_drain"] = alone[0] == full[5]
    return out


def phase_moe_serve(moe_run: dict, card: str, peak_bw, peak_ops) -> dict:
    model, cfg, itos, _ = load_codon_model(moe_run["run_dir"], device="cuda")
    cfg = cfg.replace(dropout=0.0)
    rng = np.random.default_rng(0)
    drain(model, cfg, build_requests(rng, 8), kv_quant=False)  # warm-up
    reqs = build_requests(rng, REQUESTS)  # [serve]'s mix
    da.decode_attention.launches = 0  # the MoE serving path's drain only
    results, seconds, eng = drain(model, cfg, reqs, kv_quant=False)
    decode_launches = da.decode_attention.launches
    steps = eng.stats()["decode_steps"]
    delivered = sum(len(r.tokens) for r in results.values())
    dense_tps = delivered / seconds
    spec = dict(speculative_k=SPECULATIVE_K, draft_table=fit_draft_table(model, cfg))
    da.decode_attention_chunk.launches = 0
    results, spec_s, spec_eng = drain(model, cfg, reqs, kv_quant=False, **spec)
    chunk_launches = da.decode_attention_chunk.launches
    rounds = spec_eng.stats()["verify_rounds"]
    spec_delivered = sum(len(r.tokens) for r in results.values())
    # the chunk kernel at the shapes this drain ran it at (12 layers, heads of
    # 64, the drain's cache), ragged lengths and every slot full
    gen = torch.Generator(device="cuda").manual_seed(12)
    L, B, S, _ = spec_eng.state["k"].shape
    chunk_timed = {}
    for full in (False, True):
        name = f"moe_spec_{'full' if full else 'random'}"
        case = check_chunk_case(gen, "moe_serve_kernel", name, L, B, S, cfg.kv_heads,
                                cfg.n_head // cfg.kv_heads, SPECULATIVE_K + 1, cfg.head_dim,
                                spec_eng.state["k"].dtype, cfg.dtype, False, full,
                                peak_bw, peak_ops)
        chunk_timed[name] = time_chunk_case("moe_serve_kernel", name, case)

    # int8 weights: the attention linears only; the experts and router stay float32
    attn_f32 = block_linear_bytes(model)
    expert_bytes = lambda m: sum(p.numel() * p.element_size() for n, p in  # noqa: E731
                                 m.named_parameters() if ".mlp." in n or ".router." in n)
    experts_f32 = expert_bytes(model)
    q_model = quantize_params(copy.deepcopy(model))
    attn_int8, experts_int8 = block_linear_bytes(q_model), expert_bytes(q_model)
    results, int8_s, _ = drain(q_model, cfg, reqs, kv_quant=False)
    int8_tps = sum(len(r.tokens) for r in results.values()) / int8_s
    del q_model

    # scoring: the run's validation split, flash forward per layer and microbatch
    val = PackedDataset(str(moe_run["val_npz"]))
    fa.flash_fwd.launches = 0
    ppl_batch = 8
    t0 = time.perf_counter()
    scored = ppl.evaluate_perplexity(model, cfg, val, batch_size=ppl_batch)
    score_s = time.perf_counter() - t0
    score_launches = fa.flash_fwd.launches
    microbatches = -(-len(val) // ppl_batch)
    # the flash forward at the shape scoring ran it at (B 8 x T 512, heads of 64)
    flash_timed = check_flash_forward(gen, "moe_serve_kernel", f"moe_score_b{ppl_batch}",
                                      ppl_batch, cfg.block_size, None, peak_bw, peak_ops,
                                      H=cfg.n_head, D=cfg.head_dim)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = cfg.replace(compute_dtype="float32")
    sub = moe_run["val_npz"].with_name("val_moe_subset.npz")
    with np.load(moe_run["val_npz"]) as data:
        np.savez(sub, X=data["X"][:MOE_CPU_WINDOWS], Y=data["Y"][:MOE_CPU_WINDOWS])
    on_card = ppl.evaluate_perplexity(model, f32, sub, batch_size=MOE_CPU_WINDOWS)["nll"]
    cpu_model = copy.deepcopy(model).cpu()
    on_cpu = ppl.evaluate_perplexity(cpu_model, f32, sub, batch_size=MOE_CPU_WINDOWS)["nll"]
    del cpu_model
    nll_err = abs(on_card - on_cpu) / abs(on_cpu)

    small = CodonGPTConfig(**dict(MAIN, n_layer=2, compute_dtype="float32", moe_experts=4,
                                  moe_top_k=2))
    torch.manual_seed(8)
    parity = moe_f32_serving(params_to_jax(CodonGPT(small), small), small)
    out = dict(model="the [moe_train] run: 12L8H d512 bf16, MoE 4 experts top-2",
               requests=len(reqs), slots=ENGINE["slots"], delivered_tokens=delivered,
               seconds=seconds, delivered_tokens_per_s=dense_tps, decode_steps=steps,
               ms_per_decode_step=seconds * 1e3 / steps, decode_launches=decode_launches,
               spec_k=SPECULATIVE_K, spec_delivered_tokens=spec_delivered, spec_seconds=spec_s,
               spec_tokens_per_s=spec_delivered / spec_s, verify_rounds=rounds,
               accept_rate=spec_eng.stats()["speculative_accept_rate"],
               chunk_launches=chunk_launches,
               attention_bytes_f32=attn_f32, attention_bytes_int8=attn_int8,
               expert_router_bytes_f32=experts_f32, expert_router_bytes_int8=experts_int8,
               int8_tokens_per_s=int8_tps, int8_over_dense=int8_tps / dense_tps,
               score_nll=scored["nll"], score_perplexity=scored["perplexity"], score_s=score_s,
               score_flash_launches=score_launches, want_score_launches=cfg.n_layer * microbatches,
               f32_nll_card=on_card, f32_nll_cpu=on_cpu, f32_nll_rel_err=nll_err,
               f32_2layer_greedy=parity, card=card)
    log("moe_serve", **out)
    if decode_launches == 0 or decode_launches != cfg.n_layer * steps:
        raise AssertionError(f"decode launches {decode_launches} != {cfg.n_layer} x {steps}")
    if chunk_launches == 0 or chunk_launches != cfg.n_layer * rounds:
        raise AssertionError(f"chunk launches {chunk_launches} != {cfg.n_layer} x {rounds}")
    if attn_int8 * 4 != attn_f32 or experts_int8 != experts_f32:
        raise AssertionError("int8 weights: attention bytes not a quarter, or experts changed")
    if score_launches != cfg.n_layer * microbatches or not np.isfinite(scored["nll"]):
        raise AssertionError(f"scoring: {score_launches} flash launches, nll {scored['nll']}")
    if nll_err > SCORE_NLL_RTOL or not all(parity.values()):
        raise AssertionError(f"card against CPU: nll {nll_err}, greedy {parity}")
    return {"model": model, "cfg": cfg, "decode": decode_launches, "chunk": chunk_launches,
            "score": score_launches, "chunk_timed": chunk_timed, "flash_timed": flash_timed}


def phase_moe_throughput(card: str) -> dict:
    """``benchmark_moe`` (dense, top-1, top-2; 1 measured group each, a
    subprocess each), then one profiled MoE group split by part."""
    with tempfile.TemporaryDirectory(prefix="smoke_moe_bench_") as tmp:
        out = Path(tmp) / "moe.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = bench_moe.main(["--skip_quality", "--measure_steps", "1", "--out", str(out)])
        report = json.loads(out.read_text())["throughput_d512"]
    rows = {r["name"]: r for r in report["candidates"]}
    log("moe_throughput", rc=rc, protocol=report["protocol"], candidates={
        name: {k: r.get(k) for k in ("ok", "error", "nonpad_tokens_per_sec", "ms_per_group",
                                     "peak_memory_bytes", "rel_to_dense", "last_loss",
                                     "detail")}
        for name, r in rows.items()}, card=card)
    if rc or not all(r.get("ok") for r in rows.values()):
        raise AssertionError("a benchmark_moe candidate failed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_main.main(["--moe", "--groups", "1", "--top", "12"])
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    head = lines[0]
    split = next(line["moe_device_split"] for line in lines if "moe_device_split" in line)
    log("moe_profile", **{k: v for k, v in head.items() if k != "card"},
        moe_device_split=split,
        top_kernels=[line for line in lines if "kernel" in line], card=card)
    return {"rows": rows, "profile": head, "split": split}


def phase_embeddings(runs: list[tuple[str, dict]], card: str, peak_bw, peak_ops) -> dict:
    """Embeddings of 64 validation windows in the three pooling modes on each
    run, the float32 card against the CPU, attention maps at B 1 x T 512, the
    flash forward at the last run's extraction shape, and the two CLIs."""
    launches, out = {}, {}
    for name, run in runs:
        model, cfg, itos, stoi = load_codon_model(run["run_dir"], device="cuda")
        cfg = cfg.replace(dropout=0.0)
        with np.load(run["val_npz"]) as data:
            X = data["X"][:EMBED_WINDOWS]
        fa.flash_fwd.launches = 0  # this run's extraction only
        t0 = time.perf_counter()
        pooled = {mode: emb_lib.extract_embeddings(model, cfg, X, mode=mode, batch_size=64)
                  for mode in emb_lib.POOLING_MODES}
        seconds = time.perf_counter() - t0
        launches[name] = fa.flash_fwd.launches
        batches = len(emb_lib.POOLING_MODES) * -(-len(X) // 64)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        f32 = cfg.replace(compute_dtype="float32")
        sub = X[:SCORE_CPU_WINDOWS]
        card_f32 = emb_lib.extract_embeddings(model, f32, sub, mode="mean_nonpad")
        cpu_f32 = emb_lib.extract_embeddings(copy.deepcopy(model).cpu(), f32, sub,
                                             mode="mean_nonpad")
        f32_err = float(np.abs(card_f32 - cpu_f32).max())
        idx = torch.from_numpy(X[:1].astype(np.int64)).cuda()
        with torch.no_grad():
            maps = codon_gpt_mod.attention_maps(model, cfg, idx)
        seg = segment_ids(idx, cfg.sep_id)
        allowed = structure_mask(idx.shape[1], idx.shape[1], segment_ids=seg,
                                 device="cuda")[0, 0]
        row_err = max(float((m.sum(-1) - 1).abs().max()) for m in maps)
        masked_zero = all(bool((m[0][:, ~allowed] == 0).all()) for m in maps)
        finite = all(np.isfinite(v).all() for v in pooled.values())
        out[name] = dict(windows=len(X), shapes={k: list(v.shape) for k, v in pooled.items()},
                         seconds=seconds, flash_launches=launches[name],
                         want_launches=cfg.n_layer * batches, f32_card_vs_cpu_max_abs=f32_err,
                         maps=len(maps), map_shape=list(maps[0].shape),
                         map_row_sum_max_err=row_err, masked_entries_zero=masked_zero,
                         finite=finite)
        if (not finite or launches[name] != cfg.n_layer * batches or f32_err > EMBED_F32_ATOL
                or row_err > 1e-5 or not masked_zero or len(maps) != cfg.n_layer):
            log("embeddings", run=name, **out[name], card=card)
            raise AssertionError(f"embeddings of {name}: {out[name]}")
        del model
    # the flash forward at the shape the last run's extraction (the MoE run's,
    # heads of 64) ran it at; the trainer run's shape is [score]'s b64_full
    name, run = runs[-1]
    gen = torch.Generator(device="cuda").manual_seed(13)
    flash_timed = check_flash_forward(gen, "embeddings_kernel", f"{name}_b64", 64,
                                      cfg.block_size, None, peak_bw, peak_ops,
                                      H=cfg.n_head, D=cfg.head_dim)
    # the CLIs on the MoE run
    tmp = Path(run["run_dir"])
    fasta = tmp / "probe.fasta"
    rng = np.random.default_rng(23)
    fasta.write_text("".join(f">cds{i}\nATG" + "".join(rng.choice(list("ACGT"), 3 * n)) + "TAA\n"
                             for i, n in enumerate((40, 120, 300))))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_extract = extract_cli([str(run["run_dir"]), "--input", str(fasta), "--out",
                                  str(tmp / "probe_emb.npz"), "--pooling", "mean_content"])
        rc_attention = attention_cli([str(run["run_dir"])])
    printed = buf.getvalue()
    from genomics_lm_torch.evals.visualizer import _plt

    log("embeddings", runs=out, cli_rc=[rc_extract, rc_attention],
        figures="drawn" if _plt() is not None else "not drawn (no matplotlib)",
        cli_output=printed.strip().splitlines()[:3] + ["..."], card=card)
    print(printed, end="", flush=True)
    if rc_extract or rc_attention or "[extract] wrote (3, 512)" not in printed:
        raise AssertionError("the extraction CLIs failed")
    return {"launches": launches, "flash_timed": flash_timed}


def phase_noprop(trained: dict, card: str) -> dict:
    """``train_noprop`` at 10L8H d384, block 512, on phase 15's corpus: 2
    epochs, then a resume to a third."""
    with tempfile.TemporaryDirectory(prefix="smoke_noprop_") as tmp:
        tmp = Path(tmp)
        corpus = Path(trained["val_npz"]).parent
        cfg_path = tmp / "noprop.yaml"
        m = train_main.MAIN_TRAIN
        cfg_path.write_text("\n".join([
            f"train_npz: {corpus / 'train.npz'}", f"val_npz: {corpus / 'val.npz'}",
            f"block_size: {m['block_size']}", f"n_layer: {m['n_layer']}",
            f"n_head: {m['n_head']}", f"n_embd: {m['n_embd']}", "batch_size: 16",
            "epochs: 2", "learning_rate: 0.0005", "seed: 1337"]) + "\n")
        argv = ["--config", str(cfg_path), "--run_root", str(tmp / "runs"), "--run_id", "np"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            rc = noprop_cli(argv)
            first_s = time.perf_counter() - t0
            cfg_path.write_text(cfg_path.read_text().replace("epochs: 2", "epochs: 3"))
            rc_resume = noprop_cli(argv + ["--resume",
                                           str(tmp / "runs" / "np" / "checkpoints" / "last.npz")])
        rows = (tmp / "runs" / "np" / "scores" / "curves.csv").read_text().strip().splitlines()[1:]
        payload = load_checkpoint(tmp / "runs" / "np" / "checkpoints" / "last.npz")
    ncfg = CodonGPTConfig(vocab_size=68, block_size=m["block_size"], n_layer=m["n_layer"],
                          n_head=m["n_head"], n_embd=m["n_embd"])
    model = noprop_lib.params_from_jax(payload["model"], ncfg, "cuda")
    with np.load(Path(trained["val_npz"])) as data:
        x = torch.from_numpy(data["X"][:8].astype(np.int64)).cuda()
        y = torch.from_numpy(data["Y"][:8].astype(np.int64)).cuda()
    with torch.no_grad():
        total, parts = noprop_lib.noprop_loss(model, ncfg, x, y,
                                              torch.Generator(device="cuda").manual_seed(0))
    losses = [float(v) for r in rows for v in r.split(",")[1:]]
    out = dict(model="NoProp 10L8H d384, block 512, float32, einsum attention",
               rc=[rc, rc_resume], epochs=len(rows), curves=rows, first_run_s=first_s,
               loss=float(total), ce=float(parts["ce"]),
               block_mse=[float(b) for b in parts["block_mse"]], card=card)
    log("noprop", **out)
    if rc or rc_resume or len(rows) != 3 or not np.isfinite(losses + [out["loss"]]).all():
        raise AssertionError("the NoProp runs failed or a loss is not finite")
    if len(out["block_mse"]) != ncfg.n_layer:
        raise AssertionError(f"{len(out['block_mse'])} block losses for {ncfg.n_layer} layers")
    return out


# --- phases 29-32: data preparation, evaluation, MoE quality, the dashboard -----

DEMO_GENES, DEMO_SEED = 800, 1337  # benchmark_moe's corpus defaults
DEMO_BLOCKS = (256, 512)
EVAL_BATCH, EVAL_BOOTSTRAP = 64, 1000
SALIENCY_PROBE = "ATGAAACCCGGGTTT"  # run_full_analysis's default: T 6 with BOS
SALIENCY_RTOL = 1e-4
SALIENCY_RTOL_REASON = (
    "saliency runs in float32 on both sides (the float32 embedding rows, TF32 off): "
    "the card's GEMMs and float32 flash kernels sum in another order than the CPU's "
    "plain versions, ~1e-6 relative a layer, compounded through 10-12 layers forward "
    "and back; a missing or doubled dQ or dK/dV term, or a wrong layer, moves the "
    "gradient norms by order 1")
DASHBOARD_SEQS = ["ATGAAACCCGGGTAA", "ATGTTTGATCTGAAATAG", "ATGCCCCCCAAAGGGTTTTGA",
                  "ATGGCTGCTGCTAAATAA"]


def phase_prepare(card: str, workdir: Path) -> dict:
    """The demo corpus at ``benchmark_moe``'s defaults, prepared at blocks 256
    and 512 (``multi``, genome-disjoint, ``skip_homology``, engine native)
    twice each: every manifest validates and each block's two ids agree."""
    from genomics_lm_torch.data.demo_corpus import main as demo_corpus
    from genomics_lm_torch.data.manifest import load_dataset_manifest
    from genomics_lm_torch.data.pipeline import prepare_dataset

    records_tsv = workdir / "records.tsv"
    with contextlib.redirect_stdout(io.StringIO()):
        demo_corpus(["--out", str(records_tsv), "--genes", str(DEMO_GENES),
                     "--seed", str(DEMO_SEED)])
    with records_tsv.open() as f:
        records = [dict(r) for r in csv.DictReader(f, delimiter="\t")]
    out = {}
    for block in DEMO_BLOCKS:
        ids, seconds = [], []
        for attempt in range(2):
            d = workdir / f"dataset_bs{block}_{attempt}"
            t0 = time.perf_counter()
            manifest = prepare_dataset(records, d, block_size=block, pack_mode="multi",
                                       group_by="genome", split_seed=DEMO_SEED,
                                       skip_homology=True, audit_engine="native")
            seconds.append(time.perf_counter() - t0)
            load_dataset_manifest(d / "manifest.json", verify_artifacts=True)  # validates
            ids.append(manifest["dataset"]["id"])
        windows = {}
        for split in ("train", "val", "test"):
            with np.load(d / f"{split}_bs{block}.npz") as z:
                windows[split] = int(z["X"].shape[0])
        out[block] = dict(dir=workdir / f"dataset_bs{block}_0", ids=ids, windows=windows,
                          seconds=seconds)
        log("prepare", block=block, genes=DEMO_GENES, seed=DEMO_SEED, windows=windows,
            records=manifest["split_policy"]["record_counts"],
            tokenization=manifest["tokenization"]["stats"], dataset_ids=ids,
            ids_equal=ids[0] == ids[1], manifest_valid=True,
            scientific_valid=manifest["dataset"]["scientific_valid"], seconds=seconds,
            card=card)
        if ids[0] != ids[1] or min(windows.values()) == 0:
            raise AssertionError(f"block {block}: ids {ids}, windows {windows}")
    return out


def phase_evaluate_test(runs: list[tuple[str, dict]], data: Path, card: str, peak_bw,
                        peak_ops) -> dict:
    """The ``evaluate_test`` CLI on each run over the block-512 demo splits
    (``--train_npz``, ``--bootstrap 1000``, ``--context_ablation``): the
    flash forward launched n_layer times per microbatch (up to 64 rows) in
    each of the six passes (the model NLL, the per-row NLL, four ablation
    windows); the float32 NLL on the card within ``SCORE_NLL_RTOL`` of the
    CPU's; then the flash forward at each run's evaluation shapes against
    its plain version: the first and the last microbatch (``EpochPlan``
    pads no rows), each with its windows' segment ids, at the split's
    window length, the run's heads and compute dtype, and each pass's
    attention window."""
    from genomics_lm_torch.evals.evaluate_test import main as evaluate_cli

    test_npz, train_npz = data / "test_bs512.npz", data / "train_bs512.npz"
    with np.load(test_npz) as z:
        n_test, window_len = (int(n) for n in z["X"].shape)
        first = {"X": z["X"][:SCORE_CPU_WINDOWS], "Y": z["Y"][:SCORE_CPU_WINDOWS]}
        starts = sorted({0, (n_test - 1) // EVAL_BATCH * EVAL_BATCH})  # first, last
        microbatches = [torch.from_numpy(z["X"][a:a + EVAL_BATCH].astype(np.int64))
                        for a in starts]
    launches, out, timed = {}, {}, {}
    gen = torch.Generator(device="cuda").manual_seed(31)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, run in runs:
        report_path = Path(run["run_dir"]) / "scores" / "demo_test_evaluation.json"
        fa.flash_fwd.launches = 0  # this run's evaluation only
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = evaluate_cli([str(run["run_dir"]), "--test_npz", str(test_npz),
                               "--train_npz", str(train_npz), "--bootstrap",
                               str(EVAL_BOOTSTRAP), "--context_ablation", "--batch_size",
                               str(EVAL_BATCH), "--out", str(report_path)])
        wall = time.perf_counter() - t0
        launches[name] = fa.flash_fwd.launches
        report = json.loads(report_path.read_text())
        seconds = json.loads(buf.getvalue().split("[evaluate_test] seconds ")[1])
        model, cfg, _, _ = load_codon_model(run["run_dir"], device="cuda")
        want = 6 * cfg.n_layer * -(-n_test // EVAL_BATCH)
        # float32 on the card and on the CPU, from the same weights
        windows = MOE_CPU_WINDOWS if cfg.moe_experts else SCORE_CPU_WINDOWS
        sub = report_path.with_name("demo_test_f32_subset.npz")
        np.savez(sub, X=first["X"][:windows], Y=first["Y"][:windows])
        f32 = cfg.replace(compute_dtype="float32", dropout=0.0)
        on_card = ppl.evaluate_perplexity(model, f32, sub, batch_size=windows)["nll"]
        on_cpu = ppl.evaluate_perplexity(copy.deepcopy(model).cpu(), f32, sub,
                                         batch_size=windows)["nll"]
        del model
        rel = abs(on_card - on_cpu) / abs(on_cpu)
        margins = {k: dict(margin=m["margin_nats"], ci=[m["ci_low"], m["ci_high"]],
                           excludes_zero=m["excludes_zero"]) for k, m in report["margins"].items()}
        out[name] = dict(model_nll=report["model"]["nll"], tokens=report["model"]["tokens"],
                         baselines={k: v["cross_entropy_nats"]
                                    for k, v in report["baselines"].items()},
                         best_simple_model=report["best_simple_model"],
                         beats_best_simple=report["beats_best_simple"], margins=margins,
                         ablation={k: v["nll"] for k, v in report["context_ablation"].items()},
                         seconds=seconds, cli_wall_s=wall, test_windows=n_test,
                         flash_fwd_launches=launches[name], want_launches=want,
                         f32_card=on_card, f32_cpu=on_cpu, f32_rel_err=rel,
                         f32_windows=windows, tol=SCORE_NLL_RTOL)
        log("evaluate_test", run=name, **out[name], card=card)
        finite = all(np.isfinite(v) for v in [report["model"]["nll"], *out[name]["ablation"].values()])
        if rc or not finite or launches[name] != want or rel > SCORE_NLL_RTOL:
            raise AssertionError(f"evaluate_test on {name}: rc {rc}, launches "
                                 f"{launches[name]} (want {want}), f32 rel {rel}")
        if set(report) != {"run_id", "test_npz", "model", "baselines", "baseline_tokens",
                           "best_simple_model", "beats_best_simple", "margins",
                           "margins_protocol", "context_ablation"}:
            raise AssertionError(f"evaluate_test report keys {sorted(report)}")
        # the flash forward at every shape this run's six passes launched it at
        windows = [None, *(int(w) for w in report["context_ablation"] if w != "full")]
        for a, x in zip(starts, microbatches):
            seg = segment_ids(x, cfg.sep_id) if cfg.sep_id is not None else None
            for w in windows:
                case = f"{name}_rows{a}-{a + len(x)}_w{w or 'full'}"
                timed[case] = check_flash_forward(
                    gen, "evaluate_test_kernel", case, len(x), window_len, w, peak_bw,
                    peak_ops, H=cfg.n_head, D=cfg.head_dim, dtype=cfg.dtype, seg=seg)
    return {"launches": sum(launches.values()), "flash_timed": timed, "runs": out}


MOE_QUALITY_EPOCHS = 3  # of the script's 12, for the smoke's time


def phase_moe_quality(card: str) -> dict:
    """``python -m genomics_lm_torch.training.benchmark_moe --skip_throughput
    --converged_epochs 0 --epochs 3``: the script's default widths and corpus
    (6L4H d256, block 256, B 16, lr 1e-3, 800 demo genes) for 3 of its 12
    epochs; the 30-epoch converged pass is cut."""
    with tempfile.TemporaryDirectory(prefix="smoke_moe_quality_") as tmp:
        out = Path(tmp) / "moe_quality.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "genomics_lm_torch.training.benchmark_moe",
             "--skip_throughput", "--converged_epochs", "0", "--epochs", str(MOE_QUALITY_EPOCHS),
             "--workdir", str(Path(tmp) / "ws"),
             "--out", str(out)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"benchmark_moe quality exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        quality = json.loads(out.read_text())["quality"]
    variants = {v["name"]: {k: v[k] for k in ("val_nll", "test_nll", "val_nll_delta_vs_dense",
                                              "beats_all_markov_baselines", "n_params",
                                              "train_wall_sec", "best_val_loss")}
                for v in quality["variants"]}
    log("moe_quality", protocol=quality["protocol"], markov_baselines=quality["markov_baselines"],
        variants=variants, seconds=seconds,
        cut=f"{MOE_QUALITY_EPOCHS} of 12 epochs; the 30-epoch converged pass", card=card)
    if set(variants) != {"dense", "moe_4e_top1", "moe_4e_top2"} or not all(
            np.isfinite([v["val_nll"], v["test_nll"]]).all() for v in variants.values()):
        raise AssertionError(f"benchmark_moe quality variants {variants}")
    return {"variants": variants, "baselines": quality["markov_baselines"], "seconds": seconds}


def phase_analysis(runs: list[tuple[str, dict]], card: str, peak_bw, peak_ops) -> dict:
    """On each run: ``run_full_analysis``, every dashboard data function and
    ``generate_summary`` over its runs root. The saliency launches each flash
    kernel once a layer, and its float32 result on the card is within
    ``SALIENCY_RTOL`` of the CPU's plain versions; the playground pages
    launch the decode kernel n_layer times a cached step, and their greedy
    next codon is the same on the card and the CPU. Then the float32 flash
    kernels at the saliency's shape (B 1, T 6, dropout 0) and the decode
    kernel at the playground's against their plain versions, timed."""
    from genomics_lm_torch import dashboard
    from genomics_lm_torch.evals.analysis import run_full_analysis
    from genomics_lm_torch.evals.summaries import generate_summary

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, saliency_launches, decode_launches, shapes = {}, {}, {}, {}
    for name, run in runs:
        run_dir = Path(run["run_dir"])
        cfg = CodonGPTConfig.from_run_config(dict(load_checkpoint_meta(
            resolve_checkpoint(run_dir))["cfg"], vocab_size=68))
        L = cfg.n_layer
        shapes[name] = (cfg.n_layer, cfg.block_size, cfg.n_head, cfg.kv_heads, cfg.head_dim)
        for w in FLASH_WRAPPERS:
            w.launches = 0
        t0 = time.perf_counter()
        steps = run_full_analysis(run_dir, run["val_npz"], device="cuda")
        analysis_s = time.perf_counter() - t0
        analysis_launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
        for w in FLASH_WRAPPERS:
            w.launches = 0  # the saliency page alone
        t0 = time.perf_counter()
        sal = dashboard.saliency_data(run_dir, SALIENCY_PROBE, device="cuda")
        saliency_s = time.perf_counter() - t0
        saliency_launches[name] = {w.__name__: w.launches for w in FLASH_WRAPPERS}
        cpu_sal = dashboard.saliency_data(run_dir, SALIENCY_PROBE, device="cpu")
        sal_err = float(np.abs(sal["saliency"] - cpu_sal["saliency"]).max()
                        / np.abs(cpu_sal["saliency"]).max())
        att = dashboard.attention_data(run_dir, SALIENCY_PROBE, device="cuda")
        emb = dashboard.embeddings_data(run_dir, DASHBOARD_SEQS, device="cuda")
        da.decode_attention.launches = 0  # the playground pages only
        t0 = time.perf_counter()
        with _Timed(decode_mod, "decode_step") as cached:
            nxt = dashboard.playground_next_codon(run_dir, "ATGAAACCC", device="cuda")
            page = dashboard.playground_generate(run_dir, "ATGAAA", device="cuda")
        playground_s = time.perf_counter() - t0
        decode_launches[name] = da.decode_attention.launches
        cpu_nxt = dashboard.playground_next_codon(run_dir, "ATGAAACCC", device="cpu")
        browser = dashboard.run_browser_data(run_dir.parent)
        details = dashboard.run_details_data(run_dir)
        summary = generate_summary(run_dir.parent)
        probs = [r["prob"] for r in nxt["next"]]
        out[name] = dict(
            analysis_steps=sorted(steps), analysis_s=analysis_s,
            analysis_flash_launches=analysis_launches,
            next_token_probe=steps["next_token_probe"], saliency_top=steps["saliency"]["top"],
            saliency=[float(x) for x in sal["saliency"]], saliency_s=saliency_s,
            saliency_launches=saliency_launches[name], want_saliency_launches=L,
            saliency_f32_card_vs_cpu=sal_err, tol=SALIENCY_RTOL,
            attention_shape=list(att["attention"].shape),
            attention_row_sum_err=float(np.abs(att["attention"].sum(-1) - 1).max()),
            embeddings_shape=list(emb["embeddings"].shape), pca_shape=list(emb["pca"].shape),
            next_top=nxt["next"][0], next_top_cpu=cpu_nxt["next"][0],
            next_top2_margin=probs[0] - probs[1], generated_codons=page["info"]["generated_codons"],
            had_terminal_stop=page["info"]["had_terminal_stop"], playground_s=playground_s,
            cached_steps=cached.calls, decode_launches=decode_launches[name],
            browser_runs=len(browser["table"]), curve_series=sorted(details["series"]),
            summary=str(summary.name))
        log("analysis", run=name, **out[name], card=card)
        finite = (np.isfinite(sal["saliency"]).all() and np.isfinite(emb["pca"]).all()
                  and np.isfinite(att["attention"]).all())
        if (not finite or any(v != L for v in saliency_launches[name].values())
                or sal_err > SALIENCY_RTOL or out[name]["attention_row_sum_err"] > 1e-4
                or decode_launches[name] == 0 or decode_launches[name] != L * cached.calls
                or nxt["next"][0]["token"] != cpu_nxt["next"][0]["token"]
                or not summary.exists() or not browser["table"]):
            raise AssertionError(f"analysis of {name}: {out[name]}")
    # the float32 flash kernels at the saliency's shape, and the decode kernel at
    # the playground's (one sequence over a whole-block cache), each run's heads
    gen = torch.Generator(device="cuda").manual_seed(37)
    timed, decode_timed = {}, {}
    T = len(SALIENCY_PROBE) // 3 + 1
    for name, (L, S, hq, hkv, d) in shapes.items():
        timed[name] = check_flash_case(gen, "analysis_kernel", f"saliency_{name}_d{d}", 1, hq,
                                       hkv, T, T, d, torch.float32, None, 0.0, 97, True,
                                       peak_bw, peak_ops)
        case = f"playground_{name}_d{d}"
        q, k, v, mask, ks, vs, err, nan_err = check_decode_case(
            gen, "analysis_decode", case, L, 1, S, hkv, hq // hkv, d, torch.bfloat16,
            torch.bfloat16, "serve")
        decode_timed[name] = time_decode_case(case, q, k, v, mask, ks, vs, hkv, hq // hkv,
                                              da.decode_attention, peak_bw, peak_ops, err,
                                              nan_err, "analysis_decode_time")
    return {"saliency": saliency_launches, "decode": decode_launches, "flash_timed": timed,
            "decode_timed": decode_timed, "runs": out}


# --- phases 33-37: the demo run, motifs, probes, prefix generation, the design loop --

MOTIF_ROWS = 256  # mine_motifs' default --max_windows (rows of the split)
MOTIF_CPU_ROWS = 4  # rows whose float32 window embeddings run on both devices
CARD_CPU_RTOL = 1e-5
CARD_CPU_RTOL_REASON = (
    "float32 on both devices (TF32 off) from the same weights and inputs: only the order "
    "of the float32 sums differs (~1e-7 relative per operation); a wrong window, layer, "
    "mask or update moves a value by far more than 1e-5 of the largest")
PROBE_EPOCHS = 3  # of fit_mlp's default 20 on ~100k windows
# the card-against-CPU run: 4 AdamW steps of 64 rows, held to CARD_CPU_RTOL;
# longer float32 runs drift further apart (32 steps on these embeddings part
# by a few 1e-5 of the largest weight)
PROBE_CPU_ROWS, PROBE_CPU_EPOCHS = 256, 1
PREFIX_K_LIST = "1,3,5,10"  # eval_generation_prefix's default
PREFIX_SAMPLES = 1  # of the quick preset's 2 per (gene, k), for the smoke's time
DESIGN_CPU = ["--n_candidates", "2", "--budget", "1200"]  # the CPU run's cut of the defaults


def card_vs_cpu_rel(card, cpu) -> float:
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    return float(np.abs(card - cpu).max()) / max(float(np.abs(cpu).max()), 1e-12)


DEMO_RUN_G, DEMO_RUN_EPOCHS = 2, 12  # 12 steps an epoch over the 199 train windows


def phase_demo_run(data: Path, card: str) -> dict:
    """The train CLI at the main path's config (``run_yaml``: 10L8H d384,
    block 512, bf16 flash) on the block-512 demo splits, G 2 for 12 epochs.
    Phase 15's run takes 8 steps on uniform random codons and still repeats
    its last codon, so it never reaches a stop codon; this run learns the
    corpus's codon usage, stops included, for the four phases after it."""
    workdir = data.parent / "demo_run"
    workdir.mkdir(exist_ok=True)
    config = run_yaml(workdir / "demo.yaml", data / "train_bs512.npz", data / "val_bs512.npz",
                      G=DEMO_RUN_G, epochs=DEMO_RUN_EPOCHS, run_id="smoke-demo")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli(["--config", str(config), "--run_root", str(workdir / "runs")])
    seconds = time.perf_counter() - t0
    run_dir = workdir / "runs" / "smoke-demo"
    with (run_dir / "scores" / "curves.csv").open() as f:
        curves = list(csv.DictReader(f))
    val = [float(r["val_loss"]) for r in curves]
    row = dict(run=run_dir.name, epochs=len(curves), seconds=seconds, val_loss=val,
               config=f"10L8H d384 block 512 bf16 flash, B 8 x G {DEMO_RUN_G}")
    log("demo_run", **row, card=card)
    if rc != 0 or not all(np.isfinite(val)) or val[-1] >= val[0]:
        raise AssertionError(f"demo run: {row}")
    return {"run_dir": run_dir}


def phase_motifs(trained: dict, data: Path, card: str, peak_bw, peak_ops) -> dict:
    """``mine_motifs`` at its defaults on the demo run (``phase_demo_run``) over the block-512
    demo train split: one ``hidden_states`` pass over its rows (the flash
    forward n_layer times), the window embeddings pooled on the card, KMeans
    (sklearn) when it imports here. Then the embeddings again, timed; float32
    on the card against the CPU; the flash forward at the pass's shape."""
    from genomics_lm_torch.evals.mine_motifs import main as mine_cli
    from genomics_lm_torch.evals.motifs import extract_window_embeddings

    run_dir, train_npz = trained["run_dir"], data / "train_bs512.npz"
    model, cfg, _, _ = load_codon_model(run_dir, device="cuda")
    cfg = cfg.replace(dropout=0.0)
    ds = PackedDataset(str(train_npz))
    x, _ = ds.fetch_batch(list(range(min(len(ds), MOTIF_ROWS))))
    have_sklearn = importlib.util.find_spec("sklearn") is not None
    out_json = Path(run_dir) / "scores" / "motifs.json"
    fa.flash_fwd.launches = 0  # the main path's run only
    t0 = time.perf_counter()
    if have_sklearn:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mine_cli([str(run_dir), "--npz", str(train_npz), "--out", str(out_json),
                           "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"mine_motifs exited {rc}")
        report = json.loads(out_json.read_text())
    else:
        extract_window_embeddings(model, cfg, x, exclude_ids=[0])
        torch.cuda.synchronize()
        report = None
        log("motifs", clustering="not run: sklearn does not import on this machine, and "
            "genomics_lm_torch/evals/motifs.py::MotifClusterer clusters with sklearn's KMeans; "
            "the embedding pass and its checks run", card=card)
    cli_seconds = time.perf_counter() - t0
    launches = fa.flash_fwd.launches

    t0 = time.perf_counter()
    emb, meta = extract_window_embeddings(model, cfg, x, exclude_ids=[0])
    extract_seconds = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = cfg.replace(compute_dtype="float32")
    sub = x[:MOTIF_CPU_ROWS]
    card_emb, card_meta = extract_window_embeddings(model, f32, sub, exclude_ids=[0])
    cpu_emb, cpu_meta = extract_window_embeddings(copy.deepcopy(model).cpu(), f32, sub,
                                                  exclude_ids=[0])
    rel = card_vs_cpu_rel(card_emb, cpu_emb)
    order_ok = meta == sorted(meta) and all(e - s == 9 for _, s, e in meta)
    row = dict(run=str(Path(run_dir).name), rows=int(x.shape[0]), T=int(x.shape[1]),
               windows=len(meta), embedding_shape=list(emb.shape),
               embedding_mb=emb.nbytes / 1e6, sklearn=have_sklearn,
               clusters=report["n_clusters"] if report else None,
               clusters_with_known_motif=(sum(bool(c["known_motifs"])
                                              for c in report["clusters"].values())
                                          if report else None),
               cli_seconds=cli_seconds, extract_seconds=extract_seconds,
               clustering_seconds=(cli_seconds - extract_seconds) if report else None,
               flash_fwd_launches=launches, want_launches=cfg.n_layer,
               f32_card_vs_cpu_rel=rel, f32_rows=MOTIF_CPU_ROWS, tol=CARD_CPU_RTOL,
               tol_reason=CARD_CPU_RTOL_REASON, finite=bool(np.isfinite(emb).all()),
               metadata_in_order=order_ok)
    log("motifs", **row, card=card)
    if (launches != cfg.n_layer or rel > CARD_CPU_RTOL or card_meta != cpu_meta
            or not row["finite"] or not order_ok or not meta):
        raise AssertionError(f"motifs: {row}")
    # the flash forward at this pass's shape: every row at T 512, the rows' own
    # segments, the run's heads, bf16 (the run's dtype) and float32
    gen = torch.Generator(device="cuda").manual_seed(41)
    seg = segment_ids(torch.from_numpy(x.astype(np.int64)), cfg.sep_id)
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = f"b{x.shape[0]}_{str(dtype).removeprefix('torch.')}"
        timed[name] = check_flash_forward(
            gen, "motifs_kernel", name, x.shape[0], x.shape[1], None, peak_bw,
            peak_ops if dtype == torch.bfloat16 else F32_PEAK_OPS, H=cfg.n_head,
            D=cfg.head_dim, seg=seg, dtype=dtype)
    del model
    return {"launches": launches, "emb": emb, "meta": meta, "x": x, "flash_timed": timed,
            "run": row}


def phase_probes(motifs: dict, card: str) -> dict:
    """``fit_mlp`` on the card over the motif pass's window embeddings, each
    labelled with its first token's amino-acid class (or "special"); then
    float32 at dropout 0 on the card against the CPU from the same init."""
    from genomics_lm_torch.evals.probes import fit_mlp
    from genomics_lm_torch.generation.genetic_code import CODON_TABLE
    from genomics_lm_torch.tokenizers.codon import VOCAB

    x, meta, emb = motifs["x"], motifs["meta"], motifs["emb"]
    first = [VOCAB[int(x[b, s])] for b, s, _ in meta]
    names = [CODON_TABLE.get(t, "special") for t in first]
    classes = sorted(set(names))
    y = np.asarray([classes.index(n) for n in names])
    t0 = time.perf_counter()
    result = fit_mlp(emb, y, epochs=PROBE_EPOCHS, device="cuda")
    seconds = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    sub_x, sub_y = emb[:PROBE_CPU_ROWS], y[:PROBE_CPU_ROWS]
    kw = dict(epochs=PROBE_CPU_EPOCHS, dropout=0.0, seed=5)
    on_card = fit_mlp(sub_x, sub_y, device="cuda", **kw)
    on_cpu = fit_mlp(sub_x, sub_y, device="cpu", **kw)
    rel = max(card_vs_cpu_rel(a[k], b[k]) for a, b in zip(on_card.params, on_cpu.params)
              for k in ("w", "b"))
    proba_rel = card_vs_cpu_rel(on_card.y_proba, on_cpu.y_proba)
    same_pred = bool(np.array_equal(on_card.y_pred, on_cpu.y_pred))
    # the ranking metrics move by a whole swap (1 / (positives x negatives))
    # when two near-tied probabilities trade places: logged, not held
    metric_err = max(abs(on_card.metrics[k] - on_cpu.metrics[k]) for k in on_cpu.metrics)
    row = dict(windows=len(y), classes=len(classes), epochs=PROBE_EPOCHS,
               seconds=seconds, seconds_per_epoch=seconds / PROBE_EPOCHS,
               metrics=result.metrics, f32_rows=PROBE_CPU_ROWS,
               f32_epochs=PROBE_CPU_EPOCHS, f32_param_rel=rel, f32_proba_rel=proba_rel,
               f32_same_predictions=same_pred, f32_metric_abs=metric_err,
               tol=CARD_CPU_RTOL, tol_reason=CARD_CPU_RTOL_REASON)
    log("probes", **row, card=card)
    if rel > CARD_CPU_RTOL or proba_rel > CARD_CPU_RTOL or not same_pred or \
            on_card.metrics.keys() != on_cpu.metrics.keys() or \
            not np.isfinite(result.metrics["accuracy"]):
        raise AssertionError(f"probes: {row}")
    return row


def _cache_shape(model, cfg, cache, token):
    return int(cache["seg"].shape[1]), int(cache["length"])


def phase_gen_prefix(trained: dict, data: Path, card: str, peak_bw, peak_ops) -> dict:
    """``eval_generation_prefix --preset quick --samples 1`` on the demo run over the
    block-512 demo splits with ``--nll_controls``, ``--emit_replay`` and the
    memorization audit: seconds by part, the decode kernel launched n_layer
    times a cached step and the flash forward n_layer times a scored window;
    the replay through ``data/replay.py``; ``token_nlls`` float32 on the card
    against the CPU; the two kernels at this path's own shapes."""
    from genomics_lm_torch.evals import gen_prefix as gp
    from genomics_lm_torch.evals.eval_generation_prefix import main as prefix_cli
    from genomics_lm_torch.data.replay import GeneratedTerminationReplayDataset

    run_dir = Path(trained["run_dir"])
    label, replay = "smoke_gen_prefix", run_dir / "scores" / "smoke_gen_prefix_replay.jsonl"
    argv = [str(run_dir), "--npz", str(data / "val_bs512.npz"), "--train_npz",
            str(data / "train_bs512.npz"), "--preset", "quick", "--samples",
            str(PREFIX_SAMPLES), "--k_list", PREFIX_K_LIST,
            "--nll_controls", "--emit_replay", str(replay), "--out_label", label,
            "--device", "cuda"]
    da.decode_attention.launches = 0  # the main path's run only
    fa.flash_fwd.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), _Timed(decode_mod, "forward") as uncached, \
            _Timed(decode_mod, "decode_step", record=_cache_shape) as steps, \
            _Timed(gc, "generate_model_raw") as raw, \
            _Timed(gc, "generate_cds_constrained") as constrained, \
            _Timed(gp, "score_sample") as scoring, \
            _Timed(gp, "continuation_nll_vs_controls") as controls, \
            _Timed(gp, "token_nlls", record=lambda dec, ids: len(list(ids))) as nlls, \
            _Timed(gp, "build_train_ngram_indexes") as index, \
            _Timed(gp, "fit_train_unigram") as unigram:
        rc = prefix_cli(argv)
    wall = time.perf_counter() - t0
    decode_launches, flash_launches = da.decode_attention.launches, fa.flash_fwd.launches
    printed = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"eval_generation_prefix exited {rc}: {printed[-400:]}")
    model, cfg, itos, stoi = load_codon_model(run_dir, device="cuda")
    L = cfg.n_layer
    forwards = sum(1 for n in nlls.records if n >= 2)
    out_dir = run_dir / "scores" / label
    with (out_dir / "protocol_summary.csv").open() as f:
        summary = list(csv.DictReader(f))
    with (out_dir / "protocol_samples.csv").open() as f:
        samples = list(csv.DictReader(f))
    n_replay = sum(1 for line in replay.read_text().splitlines() if line.strip())
    loaded = len(GeneratedTerminationReplayDataset(replay, cfg.block_size)) if n_replay else 0
    parts = dict(generation=raw.seconds + constrained.seconds,
                 scoring=scoring.seconds - controls.seconds, controls=controls.seconds,
                 audit=index.seconds + unigram.seconds, wall=wall)
    lengths = sorted(n - 1 for n in nlls.records if n >= 2)
    row = dict(run=run_dir.name, samples=len(samples), summary_rows=len(summary),
               seconds=parts, generations=raw.calls + constrained.calls,
               cached_decode_steps=steps.calls, uncached_forwards=uncached.calls,
               token_nll_forwards=forwards, decode_launches=decode_launches,
               want_decode=L * steps.calls, flash_fwd_launches=flash_launches,
               want_flash=L * (forwards + uncached.calls),
               nll_T=dict(min=lengths[0], median=lengths[len(lengths) // 2], max=lengths[-1]),
               cache_S=sorted({s for s, _ in steps.records}), replay_records=n_replay,
               replay_rows_loaded=loaded,
               median_gqs={f"{r['protocol']}_k{r['k']}": float(r["median_gqs"])
                           for r in summary},
               termination_rate={f"{r['protocol']}_k{r['k']}": float(r["termination_rate"])
                                 for r in summary})
    log("gen_prefix", **row, card=card)
    if (decode_launches == 0 or decode_launches != row["want_decode"] or flash_launches == 0
            or flash_launches != row["want_flash"] or not samples
            or len(samples) != row["generations"] or loaded != n_replay):
        raise AssertionError(f"gen_prefix: {row}")

    # token_nlls float32 on the card against the CPU on two generated samples
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = cfg.replace(compute_dtype="float32", dropout=0.0)
    card_dec = CachedDecoder(model, f32)
    cpu_dec = CachedDecoder(copy.deepcopy(model).cpu(), f32)
    fasta = (out_dir / "generated_protocols.fasta").read_text().split()[1::2]
    rel = 0.0
    for dna in fasta[:2]:
        ids = [stoi["<BOS_CDS>"]] + [stoi[dna[i:i + 3]] for i in range(0, len(dna) - 2, 3)]
        rel = max(rel, card_vs_cpu_rel(gp.token_nlls(card_dec, ids),
                                       gp.token_nlls(cpu_dec, ids)))
    log("gen_prefix", token_nlls_f32_card_vs_cpu_rel=rel, tol=CARD_CPU_RTOL, card=card)
    if rel > CARD_CPU_RTOL:
        raise AssertionError(f"token_nlls card against CPU: {rel}")
    # the flash forward at token_nlls' B 1 shapes (shortest, median, longest
    # window, one segment), and the decode kernel at the generations' cache
    gen = torch.Generator(device="cuda").manual_seed(43)
    flash_timed = {}
    for key in ("min", "median", "max"):
        T = row["nll_T"][key]
        flash_timed[f"b1_t{T}"] = check_flash_forward(
            gen, "gen_prefix_kernel", f"b1_t{T}", 1, T, None, peak_bw, peak_ops,
            H=cfg.n_head, D=cfg.head_dim, seg=torch.zeros((1, T), dtype=torch.int32),
            dtype=cfg.dtype)
    S = max(row["cache_S"])
    live = sorted(n for _, n in steps.records)[len(steps.records) // 2]
    case = f"b1_s{S}_live{live}"
    q, k, v, mask, ks, vs, err, nan_err = check_decode_case(
        gen, "gen_prefix_decode", case, L, 1, S, cfg.kv_heads, cfg.n_head // cfg.kv_heads,
        cfg.head_dim, torch.bfloat16, torch.bfloat16, live)
    decode_timed = time_decode_case(case, q, k, v, mask, ks, vs, cfg.kv_heads,
                                    cfg.n_head // cfg.kv_heads, da.decode_attention, peak_bw,
                                    peak_ops, err, nan_err, "gen_prefix_decode_time")
    del model, card_dec, cpu_dec
    return {"decode": decode_launches, "flash": flash_launches, "flash_timed": flash_timed,
            "decode_timed": {case: decode_timed}, "run": row}


def phase_design(trained: dict, data: Path, card: str) -> dict:
    """``generative_design_loop`` at its defaults with ``--esm_fold_top 2
    --fold_backend mock`` on the demo run: seconds, tokens spent, the
    decode kernel's launches (n_layer a cached step) and the termination
    rate; the candidates through ``audit_generated_sequences`` against the
    demo corpus's train-split records; then a CPU run of the loop (its cut
    in ``DESIGN_CPU``), whose candidates are re-scored in float32 on the card
    and on the CPU (``score_sequence``'s mean log-probability)."""
    from genomics_lm_torch.data.leakage import audit_generated_sequences
    from genomics_lm_torch.evals.playground import dna_to_context_ids, score_sequence
    from genomics_lm_torch.generation.generative_design_loop import main as design_cli

    run_dir = Path(trained["run_dir"])
    out = {}
    for device, extra in (("cuda", []), ("cpu", DESIGN_CPU)):
        da.decode_attention.launches = 0  # each run's own
        fa.flash_fwd.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), _Timed(decode_mod, "decode_step") as steps, \
                _Timed(decode_mod, "forward") as uncached:
            rc = design_cli([str(run_dir), "--esm_fold_top", "2", "--fold_backend", "mock",
                             "--out_dir", str(run_dir / "scores" / f"design_{device}"),
                             "--device", device, *extra])
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"generative_design_loop on {device} exited {rc}")
        summary = json.loads((run_dir / "scores" / f"design_{device}" / "summary.json")
                             .read_text())
        text = (run_dir / "scores" / f"design_{device}" / "candidates.csv").read_text()
        rows = list(csv.DictReader(io.StringIO(text)))  # an empty file: no candidate
        out[device] = dict(seconds=seconds, summary=summary, rows=rows, steps=steps.calls,
                           uncached=uncached.calls, decode=da.decode_attention.launches,
                           flash=fa.flash_fwd.launches)
    model, cfg, itos, stoi = load_codon_model(run_dir, device="cuda")
    L, main = cfg.n_layer, out["cuda"]
    # the audit: the card run's candidates against the train-split records
    with (data.parent / "records.tsv").open() as f:
        records = list(csv.DictReader(f, delimiter="\t"))
    with (data / "fragment_metadata.tsv").open() as f:
        train_ids = {r["source_id"] for r in csv.DictReader(f, delimiter="\t")
                     if r["split"] == "train"}
    training = [r for r in records if r["source_id"] in train_ids]
    generated = [{"source_id": f"candidate_{r['candidate']}", "sequence": r["dna"]}
                 for r in main["rows"]]
    t0 = time.perf_counter()
    audit = audit_generated_sequences(training, generated,
                                      run_dir / "scores" / "design_cuda" / "audit.json")
    audit_seconds = time.perf_counter() - t0
    # the CPU run's candidates re-scored in float32 on both devices
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = cfg.replace(compute_dtype="float32", dropout=0.0)
    ctx = dna_to_context_ids("ATG", stoi)
    err = 0.0
    for r in out["cpu"]["rows"]:
        ids = ctx + [stoi[r["dna"][i:i + 3]] for i in range(0, len(r["dna"]), 3)]
        on_card = score_sequence(CachedDecoder(model, f32), ids)["mean_logprob"]
        on_cpu = score_sequence(CachedDecoder(copy.deepcopy(model).cpu(), f32),
                                ids)["mean_logprob"]
        err = max(err, abs(on_card - on_cpu))
    row = dict(run=run_dir.name, seconds=main["seconds"],
               tokens_spent=main["summary"]["tokens_spent"],
               solved=main["summary"]["solved"], requested=main["summary"]["requested"],
               termination_rate=main["summary"]["termination_rate"],
               folded=main["summary"].get("folded", 0),
               pairwise_identity=main["summary"]["pairwise_identity"],
               cached_decode_steps=main["steps"], decode_launches=main["decode"],
               want_decode=L * main["steps"], uncached_forwards=main["uncached"],
               flash_fwd_launches=main["flash"], want_flash=L * main["uncached"],
               audit_seconds=audit_seconds, training_records=len(training),
               audit_summary=audit["summary"], cpu_run=dict(
                   seconds=out["cpu"]["seconds"], solved=out["cpu"]["summary"]["solved"],
                   tokens_spent=out["cpu"]["summary"]["tokens_spent"]),
               rescored=len(out["cpu"]["rows"]), f32_mean_logprob_card_vs_cpu_abs=err,
               tol=CARD_CPU_RTOL)
    log("design", **row, card=card)
    if (main["decode"] == 0 or main["decode"] != row["want_decode"]
            or main["flash"] != row["want_flash"] or err > CARD_CPU_RTOL
            or not out["cpu"]["rows"] or audit["generated_count"] != len(main["rows"])):
        raise AssertionError(f"design: {row}")
    del model
    return {"decode": main["decode"], "run": row}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card_line = smi.splitlines()[0]
    print(card_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    peak_bw, peak_ops = card_peaks(kind)
    log("device", kind=kind, count=count, torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=card_line, peak_bytes_per_s=peak_bw,
        peak_bf16_ops_per_s=peak_ops)

    seconds, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:  # each phase's wall seconds, logged as it ends
        now = time.perf_counter()
        seconds[name] = round(now - mark[0], 1)
        mark[0] = now
        log("lap", name=name, seconds=seconds[name])

    phase_build()
    lap("build")
    timed = phase_kernel(peak_bw, peak_ops)
    lap("kernel")
    served = phase_serve(card_line)
    lap("serve")
    phase_parity()
    lap("parity")
    phase_http(served["model"], served["cfg"])
    lap("http")
    flash_timed = phase_flash(peak_bw, peak_ops)
    lap("flash")
    trained = phase_train(card_line)
    lap("train")
    phase_train_parity()
    lap("train_parity")
    chunk_timed = phase_chunk(peak_bw, peak_ops)
    lap("chunk")
    streamed = phase_streamed(peak_bw, peak_ops)
    lap("streamed")
    spec_served = phase_spec_serve(served["model"], served["cfg"], card_line)
    lap("spec_serve")
    phase_spec_parity()
    lap("spec_parity")
    phase_pipeline(card_line)
    lap("pipeline")
    trainer_dir = tempfile.TemporaryDirectory(prefix="smoke_trainer_")  # read by 21, 22
    trainer_run = phase_trainer(card_line, Path(trainer_dir.name))
    lap("trainer")
    phase_spec_trained(card_line, peak_bw, peak_ops)
    lap("spec_trained")
    phase_lora_d512(card_line)
    lap("lora_d512")
    finetuned = phase_finetune(card_line)
    lap("finetune")
    remat = phase_remat_contract(card_line)
    lap("remat_contract")
    int8_served = phase_int8_serve(served, card_line)
    lap("int8_serve")
    generated = phase_generate(trainer_run, card_line, peak_bw, peak_ops)
    lap("generate")
    scored = phase_score(trainer_run, generated, card_line, peak_bw, peak_ops)
    lap("score")
    del generated["model"]
    moe_dir = tempfile.TemporaryDirectory(prefix="smoke_moe_")  # read by 25, 27
    moe_run = phase_moe_train(card_line, Path(moe_dir.name))
    lap("moe_train")
    phase_moe_parity()
    lap("moe_parity")
    moe_served = phase_moe_serve(moe_run, card_line, peak_bw, peak_ops)
    lap("moe_serve")
    del moe_served["model"]
    phase_moe_throughput(card_line)
    lap("moe_throughput")
    embedded = phase_embeddings([("trainer", trainer_run), ("moe", moe_run)], card_line,
                                peak_bw, peak_ops)
    lap("embeddings")
    phase_noprop(trainer_run, card_line)
    lap("noprop")
    prepare_dir = tempfile.TemporaryDirectory(prefix="smoke_prepare_")
    prepared = phase_prepare(card_line, Path(prepare_dir.name))
    lap("prepare")
    evaluated = phase_evaluate_test([("moe", moe_run), ("trainer", trainer_run)],
                                    prepared[512]["dir"], card_line, peak_bw, peak_ops)
    lap("evaluate_test")
    phase_moe_quality(card_line)
    lap("moe_quality")
    analysed = phase_analysis([("trainer", trainer_run), ("moe", moe_run)], card_line,
                              peak_bw, peak_ops)
    lap("analysis")
    data512 = prepared[512]["dir"]
    demo_run = phase_demo_run(data512, card_line)
    lap("demo_run")
    motifs = phase_motifs(demo_run, data512, card_line, peak_bw, peak_ops)
    lap("motifs")
    phase_probes(motifs, card_line)
    lap("probes")
    del motifs["emb"]
    prefixed = phase_gen_prefix(demo_run, data512, card_line, peak_bw, peak_ops)
    lap("gen_prefix")
    designed = phase_design(demo_run, data512, card_line)
    lap("design")
    prepare_dir.cleanup()
    moe_dir.cleanup()
    trainer_dir.cleanup()
    log("phase_seconds", **seconds, total=round(sum(seconds.values()), 1))

    tile_design = ("one pass with an online softmax in float32 (SIMT) over only the 64-position "
                   "cache tiles with a live mask position, flagged by each warp from the mask "
                   "row; four cp.async stages (three for a float32 cache) of K/V head slices, "
                   "mask values and int8 scales")
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "genomics_lm_torch/csrc/decode_attention.cu",
        "replaces": "genomics_lm_tpu/ops/decode_attention.py:207",
        "launches": served["launches"],
        **timed["main_bf16"],
        "int8": dict(timed["main_int8"], launches=served["launches_int8"]),
        "serve": timed["serve_bf16"],
        "serve_int8": timed["serve_int8"],
        "full": timed["full_bf16"],
        "launches_finetune_serve": finetuned["decode"],
        "launches_int8_weights": int8_served["launches"],
        "launches_int8_weights_int8_cache": int8_served["launches_int8_cache"],
        "launches_generate": generated["decode"],
        "launches_moe_serve": moe_served["decode"],
        "launches_dashboard": sum(analysed["decode"].values()),
        "launches_gen_prefix": prefixed["decode"],
        "launches_design": designed["decode"],
        "gen_prefix_b1": prefixed["decode_timed"],
        "dashboard_b1": analysed["decode_timed"],
        "b1": generated["b1"],
        "b1_full": generated["b1_full"],
        "design": tile_design + "; one block per (kv head, slot)",
    }]
    tensor_core = ("bf16: tensor-core tiles (mma.sync m16n8k16, ldmatrix), cp.async double "
                   "buffering, band-and-segment tile skipping; float32: SIMT")
    for key, wrapper, line in (("fwd", fa.flash_fwd, 206), ("dq", fa.flash_bwd_dq, 365),
                               ("dkv", fa.flash_bwd_dkv, 390)):
        kernels.append({
            "name": wrapper.__name__,
            "route": "cuda",
            "source": "genomics_lm_torch/csrc/flash_attention.cu",
            "replaces": f"genomics_lm_tpu/ops/flash_attention.py:{line}",
            "launches": trained[wrapper.__name__],
            **flash_timed["main_bf16_dropout"][key],
            "d512": flash_timed["d512_main_bf16"][key],
            "launches_finetune": finetuned["flash"][wrapper.__name__],
            "launches_remat_contract": remat["remat"][wrapper.__name__],
            "launches_plain_contract": remat["plain"][wrapper.__name__],
            "launches_moe_train": moe_run["launches"][wrapper.__name__],
            "launches_saliency": sum(r[wrapper.__name__] for r in analysed["saliency"].values()),
            "saliency_f32": {run: t[key] for run, t in analysed["flash_timed"].items()},
            **({"launches_score": scored["launches"],
                "launches_score_mutations": scored["launches_mutations"],
                "launches_generate": generated["flash"],
                "launches_moe_score": moe_served["score"],
                "launches_embeddings": sum(embedded["launches"].values()),
                "launches_evaluate": evaluated["launches"],
                "launches_motifs": motifs["launches"],
                "launches_gen_prefix": prefixed["flash"],
                "motifs": motifs["flash_timed"],
                "gen_prefix_b1": prefixed["flash_timed"],
                "inference": scored["inference"],
                "moe_inference": {"score_b8": moe_served["flash_timed"],
                                  "embeddings_b64": embedded["flash_timed"],
                                  "evaluate": evaluated["flash_timed"]}}
               if key == "fwd" else {}),
            "design": tensor_core,
        })
    kernels.append({
        "name": "decode_attention_chunk",
        "route": "cuda",
        "source": "genomics_lm_torch/csrc/decode_attention_chunk.cu",
        "replaces": "genomics_lm_tpu/ops/decode_attention.py:565",
        "launches": spec_served["launches"],
        **chunk_timed["main_bf16"],
        "int8": dict(chunk_timed["main_int8"], launches=spec_served["launches_int8"]),
        "full": chunk_timed["full_bf16"],
        "full_int8": chunk_timed["full_int8"],
        "launches_moe_spec": moe_served["chunk"],
        "moe_spec": moe_served["chunk_timed"],
        "design": ("bf16 query, bf16 or int8 cache: tensor-core tiles (mma.sync m16n8k16, "
                   "ldmatrix), one pass with an online softmax, three cp.async stages, only "
                   "cache tiles with a live mask position read; float32 query: SIMT"),
    })
    st = streamed["timed"]
    kernels.append({
        "name": "decode_attention_streamed",
        "route": "cuda",
        "source": "genomics_lm_torch/csrc/decode_attention_streamed.cu",
        "replaces": "genomics_lm_tpu/ops/decode_attention.py:397",
        "launches": streamed["launches"],
        **st["b64_bf16"],
        "int8": st["b64_int8"], "b256": st["b256_bf16"], "b256_int8": st["b256_int8"],
        "design": tile_design + "; the S axis split over blocks in whole tiles only while "
                  "the batch leaves resident blocks idle, the last split block of a (kv head, "
                  "slot) combining the splits in the same launch",
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
