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
2b. decode stress — the decode kernel's ``main_bf16`` case of phase 3 on
   50 fresh draws, each on all 10 layers and again with NaN in the dead
   tiles, while a second stream runs 8192² bf16 products; on an error over
   ``KERNEL_ATOL`` the draw's seed and the first (layer, slot, head) that is
   off are printed, its tensors saved under ``decode_stress_failures/``
   (git-ignored), and the smoke fails.
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
   memory), each 3 warm-up, 1 measured and 1 profiled group (the CLI
   measures 20 and profiles 3; the measured groups cut for time); the
   profiled group records the card's activity only (kernels and copies,
   all its numbers read); logs
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
   JAX script's defaults, 1 serving repeat, cut from 2 for time): a 4L4H d256 model trained on
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
   x 32 against 10 x 32, ms per group over 1 more group each (cut from 3
   for time).
20. int8 serve — weight-only int8 serving: phase 4's model with its block
   linears quantized by ``quantize_params`` (their bytes, dense against
   int8, checked and logged) drains the first 72 of the 128 requests (a
   cut for time; 8 more than the 64 slots, so slots refill) with a
   bf16 and an int8 cache, each beside the dense model's drain just before it;
   every budget in-vocabulary and the decode kernel launched n_layer times
   per step; one speculative drain (K 4) launches the chunk kernel n_layer
   times per round, its draft table fitted to 64 sampled tokens (cut from
   256 for time); a 2-layer float32 int8 model gives the same greedy
   tokens on the card and on the CPU; ``benchmark_serving --int8_weights``
   prints its closed-loop report and an open-loop (``--arrival_rate``) one,
   each on 72 requests into its 64 slots (cut from the script's 256 and 128
   for time; 8 more than the slots, so slots are refilled).
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
   as is but data paths, epochs, run ids, warm-up 1 and a 2-step schedule,
   each override logged: 12L8H d512, 4 experts top-2 at capacity 1.25,
   router loss 0.01, B 8 x G 16, bf16 flash, dropout 0.1, label smoothing
   0.05) through the train CLI on a packed corpus: 1 epoch of 1 group and a
   resume to a second, beside a straight 2-epoch run (cut from 2 epochs of
   2 groups and a third, straight 3, for the smoke's time). Hard checks:
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
   ``ServingEngine`` drains the first 72 of phase 4's 128 requests into 64
   slots (a cut for time that still refills slots; decode launches = 12 x steps) and once speculatively with K 4 (chunk launches = 12 x
   rounds; the draft table fitted to 64 sampled tokens, cut from 256 for
   time), then the bf16 chunk kernel at that drain's shapes (12 layers,
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
26. moe throughput — ``training/benchmark_moe.py``'s throughput section
   with 1 measured group: dense and top-2 (top-1 cut for the smoke's time)
   tokens/s, ms per group, peak memory and ``rel_to_dense``, each in
   a subprocess, at 4 of the recipe's 12 layers and 4 of its 16
   microbatches a group (depth cuts for time); then ``profile_step.py --moe
   --n_layer 4`` (a depth cut of the profiled model):
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
29a. native — the native host library (``native/genomics_native.cpp``)
   built with g++ (its seconds logged); on the demo corpus's 800 CDS and
   their proteins each entry point against its plain version: minhash
   cluster labels (the audit's k 4 at the Jaccard of identity 0.3, and k 5
   at 0.5), codon ids, reverse complements and SHA-256 digests identical.
29b. genbank — the demo corpus written as 12 GBFF files, one a genome
   (every other gene on the minus strand, 60-200 nt spacers, an N in every
   9th spacer and in 3 genes, two plus-strand pairs overlapping by a base):
   ``extract_cds_records`` returns the 800 genes as written, a multiset in
   coding orientation; ``pipeline_prepare --gbff`` at block 512 (``multi``,
   genome-disjoint, the native homology audit on) twice, equal ids and a
   valid manifest; then one GBFF at E. coli K-12 MG1655's scale (4,641,652
   bp, 4,300 CDS, after NCBI RefSeq NC_000913.3) parsed, extracted and
   audited by the native engine, each step's seconds logged.
29c. hybrid train — ``pipeline_prepare_hybrid`` on the 12 files (block
   512, flanks 30 and 60 nt): its pad-only gate passes and the combined
   ``itos.txt`` has 74 lines; the train CLI at the main path's width
   (``run_yaml``) on the combined hybrid splits, B 8 x G 2 for 4 epochs:
   every loss finite, the last validation loss under ln 74, the model's
   vocabulary 74, each flash kernel's launches (reset just before, read just
   after) 10 a training microbatch and the forward's also 10 a validation
   microbatch; then the three flash kernels on the first real bf16
   microbatch of the hybrid train split, with its segment ids (``<UNK>``,
   id 3, separates the packed lines and marks an N), against their plain
   versions within ``FLASH_TOL``, timed beside their bounds, plain versions
   and SDPA; the microbatch's segments and the tiles visited against the
   band's logged.
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
   --skip_throughput --converged_epochs 0 --epochs 1``: dense, top-1 and
   top-2 at the script's default widths (6L4H d256, block 256, B 16, lr
   1e-3) on the demo corpus, einsum attention; per variant val and test
   NLL, the delta to dense, whether it beats every Markov floor, parameters
   and training seconds. Cut: 1 of the script's 12 epochs, 3 of its 6
   layers, 400 of its 800 genes, and the 30-epoch converged pass.
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
34. motifs — the motif pass of ``mine_motifs`` (window 9, stride 1, the
   first 256 rows) on the demo run over the block-512 demo train split, in
   process: one ``hidden_states`` pass over its rows (the flash forward
   launched n_layer times), the window embeddings pooled on the card, timed;
   the float32 embeddings on the card within ``CARD_CPU_RTOL`` of the CPU's;
   the flash forward at the pass's shape (every row at T 512, their
   segments, heads of 48), bf16 and float32, against its plain version,
   timed. The CLI itself, with its KMeans (host seconds), runs in phase
   57's worker.
35. probes — ``fit_mlp`` on the card over those embeddings, labelled by each
   window's first amino acid, for ``PROBE_EPOCHS`` epochs: seconds per epoch
   and its metrics; float32 at dropout 0 from one init, card against CPU.
36. gen_prefix — ``eval_generation_prefix --preset quick --samples 1
   --max_genes 1`` (cut from the preset's 2 samples and 10 genes for the
   smoke's time) on the demo run
   over the block-512 demo splits with ``--nll_controls``, ``--emit_replay``
   and the memorization audit: seconds of generation, scoring, controls and
   audit; the decode kernel launched n_layer times a cached step and the
   flash forward n_layer times a scored window; the replay loaded by
   ``data/replay.py``; ``token_nlls`` float32 on the card against the CPU;
   the flash forward at its B 1 windows and the decode kernel at the
   generations' cache against their plain versions, timed.
37. design — ``generative_design_loop`` at its defaults but 2 candidates
   (cut from 8 for time) with ``--esm_fold_top 2 --fold_backend
   mock``: seconds, tokens spent, decode
   launches (n_layer a cached step), the termination rate; its candidates
   through ``audit_generated_sequences`` against the demo corpus's
   train-split records; a CPU run of the loop whose candidates are
   re-scored in float32 on the card and on the CPU.

38. protein critic — the demo corpus at 800 genes of 50–510 codons (seed
   1337) translated to protein and labelled (genus as ``pfam_id``, seeded
   5-class ``ec_id``, seeded normal ``stability_score`` with 20% missing,
   seeded 8-way ``go_terms``), split by genome (genome 2 of each genus
   held out); the ``train_multi_task`` CLI at ``configs/protein_critic_12L8H.yaml``
   (12L8H d384, block 512, attention pooling, bidirectional, B 16 x 2, lr
   1e-4, float32; plus the data paths, its commented ``multi_label_tasks``
   and ``task_loss_weights`` lines and a ``go_terms`` head width) for 1
   epoch (cut from 10) and a ``--resume`` to a second: every
   loss finite, ``curves.csv`` 2 rows, seconds, sequences/s and peak memory an epoch;
   one float32 step of a 2-layer critic card against CPU within
   ``TRAIN_PARITY_TOL``; the trained critic's latents for 16 validation
   proteins card against CPU within ``CARD_CPU_RTOL``;
   ``benchmark_protein_critic_training`` at its defaults and at the
   config's width; a profiled 512-wide group (busy share, launches, top
   operations). No kernel: the protein models' attention is the einsum
   JAX's ``sdpa_xla`` computes outside any Pallas kernel.
39. protein lm — ``train_protein_lm`` at the same widths (dropout 0.1),
   causal, B 16 x 2, 1 epoch (a cut): finite loss, validation NLL.
40. protein ebm — ``train_ebm`` on the critic at its defaults for 2 epochs
   (cut from 5); ``optimize_designs_langevin`` on phase 37's candidates at
   its defaults; Langevin card against CPU at ``noise_std`` 0 for 5 steps
   (energies within ``CARD_CPU_RTOL``, the same sequence); then
   ``train_mlp_heads`` for 3 epochs (cut from 20), ``eval_multi_task_critic``,
   ``extract_protein_embeddings`` and ``protein_critic_bridge``.
41. critic guided — on the demo run, ``eval_generation_prefix
   --critic_guidance --critic_stability`` and once ``--ebm_guidance``, each
   cut to 1 gene, k 10 (k 1 cut for time), 1 sample (``CRITIC_GUIDED_CUT``); then
   ``generative_design_loop --critic_ckpt --ebm_ckpt --fold_backend mock``
   at its defaults but 2 candidates (cut from 8 for time): the
   critic columns present and finite, the decode
   kernel launched n_layer times a cached step and the flash forward
   n_layer times a scored window or uncached forward, critic forwards per
   guided codon and their share of the wall time.
42. parallel ranks — the ranks' work of phases 43-48 in two launches
   (``parallel/launch.py::spawn`` of ``parallel/workers.py::each``; each
   process takes 20-30 s to reach the card, so the workers share them):
   two ranks sharing the card over gloo run the data- and tensor-parallel
   groups, the train CLI's tensor-parallel run, the tensor-parallel
   drains and the expert-parallel and MoE work; one rank over NCCL, started
   beside them, the bit-for-bit group. The two gloo ranks, and phase 49's
   four, start before phase 41 (``prestart_ranks``) and wait for their
   release, so they reach the card while phase 41 runs; the four pipeline
   ranks are released when the two have ended, before any kernel is timed
   in phases 43-48. The kernels are built (phase 2) before any rank starts,
   so no two ranks compile at once.
43. dp train — data parallelism: the flash kernels at a rank's shape (B 4,
   H 8, T 512, heads of 48) against their plain versions and timed; then
   ``bench.py``'s step config (10L8H d384, bf16 flash, G 16 x B 8 x T 512
   global) as two ranks of B 4 sharing the card over gloo with ZeRO-1
   (``parallel/workers.py::group_steps`` through ``parallel/launch.py``):
   1 warm-up and 1 timed group (cut from 3 for time), each rank's flash
   launches G x n_layer a
   group, tokens/s, the share of wall time inside collectives and the
   moment bytes a rank (about half). A float32 group at 2 layers (a depth
   cut) and dropout 0 with uneven pad over the ranks against the one-rank card group within
   ``TRAIN_PARITY_TOL``; one rank of a data mesh over NCCL, which issues
   the data-parallel collectives and ZeRO-1's all-gather at world 1 (their
   count checked), bit for bit (both under torch's deterministic
   algorithms, in one fresh process); the mean time of a collective, gloo
   and NCCL.
44. tp train — tensor parallelism with ``residual_sharding`` (sequence
   parallelism): the flash kernels at a rank's 4 heads (B 8) checked and
   timed; the float32 parity and 1 timed group of 4 microbatches (cut from
   16 for time) at ``tensor_parallel`` 2;
   then the train CLI through its launch path (``--mesh_devices 2
   --tensor_parallel 2``, two ranks on the card) at 2 layers (cut from 10)
   for 1 epoch, and a ``--resume`` at world size 1 to a second.
44b. tp adafactor — the float32 parity group of phase 44 (2 layers at d384,
   a depth cut) under ``optimizer: adafactor``, on the same two gloo ranks
   with sequence parallelism, against the one-rank Adafactor group in the
   NCCL process: loss, gradients and weights within ``ADAFACTOR_TP_TOL``,
   every statistic, merged from the ranks into the JAX leaves, within
   ``ADAFACTOR_STAT_RTOL``. (At d384 no factored leaf falls under optax's
   128 on a rank; the CPU test holds that trap at d128.)
45. tp serve — the serving benchmark's config (phase 4's model, 64 slots,
   128 requests, ``max_seq_len`` 256) at ``tensor_parallel`` 2 on two ranks,
   at 2 layers (a depth cut from 10): the decode kernel at 4 kv heads a rank
   (bf16 and int8 caches) and the chunk kernel at its local heads against
   their plain versions and timed at 10 layers, and checked at the drains'
   2; drains with a bf16 cache, an int8 cache and speculative K 4, each of
   the 66 requests of the smallest budgets into the 64 slots, so slots
   refill (cuts for time from 128 and the first 72), the ranks' tokens
   equal, every
   budget served, each rank's decode launches n_layer a step and chunk
   launches n_layer a verify round; the 8 greedy float32 requests of the
   smallest budgets equal to the meshless engine's. Two ranks on one card are no
   scaling figure.
46. ep train — expert parallelism: the MoE recipe's model
   (``configs/stage2.6_moe_4e_top2_d512_ep2.yaml``: 12L8H d512, 4 experts
   top-2, bf16, B 8) on two ranks of ``{"data": 1, "model": 2}`` in phase
   42's launch, each holding 2 of the 4 experts and 4 of the 8 heads: the
   flash kernels at a rank's 4 heads of 64 (B 8, dropout keyed on heads 4..7
   of 8) checked and timed, and in float32 at the parity groups' shapes; a
   float32 group at 2 layers (a depth cut), capacity 0.5, B 7, against the
   one-rank card group within ``TRAIN_PARITY_TOL``; one timed bf16 group of
   ``EP_TIMED_G`` microbatches (cut from the recipe's 16): ms, non-pad
   tokens/s, the share in collectives, each rank's expert bytes (half).
47. moe dp — the same float32 MoE group on a data mesh of 2 (B 7: one rank
   holds a padding row), routed over the global microbatch, against the
   one-rank group within ``TRAIN_PARITY_TOL``; the dropped choices counted.
48. tp moe serve — the MoE recipe's model served at tensor parallel 2 (64
   slots), at 2 layers (a depth cut from 12): the decode kernel (bf16 and
   float32) and the chunk kernel at a rank's 4 kv heads of 64 against their
   plain versions, bf16 timed at 12 layers, and checked at the drains' 2;
   the 4 greedy float32 requests of the smallest budgets equal to the
   meshless engine's; a bf16 drain and a speculative K 4 drain, each of the
   66 requests of the smallest budgets into the 64 slots, so slots refill
   (cuts for time), each rank's decode and chunk launches n_layer a step or
   round.
49. pp train — GPipe: the pipeline recipe
   (``configs/stage2.6_large_12L8H_d512_pp4.yaml``: 12L8H d512, G 16 x B 8
   x T 512, bf16, dropout 0.1) on four ranks of ``{"data": 1, "pipe": 4}``
   in one launch, 3 layers a stage: the flash kernels in float32 at a
   stage's shape (bf16 at that shape is phase 7's d512 case); a float32
   group at 4 layers (one a stage), dropout 0, every row non-pad, against
   the one-rank group within ``TRAIN_PARITY_TOL``; one timed bf16 group: ms,
   tokens/s, each stage's share in sends and receives and its flash
   launches (3 layers x 16 a group), the bubble (S-1)/(M+S-1) = 3/19; then
   the train CLI at ``--mesh_devices 4 --pipeline_stages 2`` (2 layers, a
   cut, one microbatch a group) for 1 epoch and a ``--resume`` at world
   size 1 from its merged checkpoint.
50. engine — ``training/engine.py``'s Task/Strategy/Callback loop at the
   main path's width (10L8H d384, bf16 flash, dropout 0.1, B 8 x T 512
   synthetic windows with ``<SEP>`` every 97th), G 4, 2 epochs of 8
   microbatches, one NaN loss (its group aborted); straight, then stopped
   by the wall timer as group 1 commits, restored and resumed: the final
   weights bit for bit and the group and validation events equal; groups
   timed with ``utils/sync.py::hard_sync``; flash launches 10 a microbatch
   run (the forward's also 10 a validation microbatch).
51. biophysics fusion — ``training/train_biophysics_fusion.py`` on the card:
   the shape encoder fit at ``train_encoder``'s defaults (2000 x 32 codons,
   5 epochs; its loss falls), then the chained shape-guided run at the main
   path's width, 2 epochs with ``save_epochs`` on a small packed corpus:
   the encoder frozen as fitted, flash launches 10 a microbatch.
52. run tools — the preflight on the card; ``eval_epoch_sweep`` and
   ``compare_checkpoints`` over phase 51's epoch checkpoints (equal NLLs;
   the last on the card against the CPU in float32 within
   ``SCORE_NLL_RTOL``); ``sanity_kpis`` on phase 33's demo run (the decode
   kernel at B 1 in its constrained generation, 10 a decode step); then host
   only: ``compare_runs``, and the freeze of phase 29's two datasets
   (read-only) with its verification.
53. timing tools — ``training/profile_train.py`` at its defaults (10L8H
   d384, B 32 x G 4 x T 512, bf16 flash) but 2 traced steps: flash launches
   10 x 4 a step, the warm step included, a ``torch.profiler`` trace in its
   directory (its kernel time against its span logged), tokens/s beside
   phase 8's; ``serving/benchmark_decode.py`` at 32 tokens and one
   measured round (scan, stepwise ``--donate_cache``, ``--speculative 4``):
   decode launches 10 a cached step, chunk launches 10 a verify round, ms a
   step beside phase 4's; ``make_run_id``; ``hardware_monitor --device``.
54. diagnoses — on phase 33's demo run and the block-512 splits:
   ``calibration_metrics`` and ``diagnose_context_learning`` (windows 1, 2,
   4, 8, full; the flash forward 10 a microbatch of 32), the float32 NLL and
   ECE of 8 windows on the card against the CPU within ``SCORE_NLL_RTOL``,
   ``diagnose_termination_probabilities`` (32 steps) and
   ``run_decoding_termination_ablation`` (biases 0 and 4, 2 samples; the
   decode kernel at B 1, 10 a step), ``eval_ppl_baselines`` (host),
   ``benchmark_zero_shot_mutations`` on a demo CDS and a seeded table, and
   ``evaluate_termination_head`` on the demo run (the skip) and on a copy
   of it with a seeded termination head (every labelled target counted).
55. speed sweep — ``training/benchmark_training_speed.py --candidates 8x16
   --measure_steps 2`` as a process of its own, started before phase 53 and
   joined here (its probe's ~20 s to reach the card overlap phases 53-54):
   the probe ``ok`` on the card with the card's peak memory, the flash
   library loaded from the build cache, not rebuilt.
56. representation — the representation benchmarks on phase 33's demo run,
   in a worker process of their own started before phase 38 and joined
   here (``representation_worker``: they spend most of their time on the
   host): a gene set at E. coli K-12's scale (4,300 demo-corpus genes of
   seed 1337, the 7% with the highest GC3 essential: ~300, the Keio
   collection's count), ``benchmark_gene_essentiality`` and
   ``benchmark_essentiality_baselines`` with the run (the latter at 3 of its
   5 folds, a cut for time: its booster's 5 folds took 22.7 s of host; the
   flash forward 10 x ⌈4,300 / 64⌉ each; every F1 finite, ``codon_freq_logreg`` at or over
   ``CODON_LOGREG_F1_FLOOR`` and both codon-frequency columns equal to
   sklearn's reports on the same bytes), the run's embeddings in two
   poolings through ``select_grouped_representation`` over a seeded
   cluster column, 64 genes' float32 embeddings within ``EMBED_F32_ATOL``
   of the CPU, the three structural probes at their defaults (batch 1: 10
   x 48, 10 x 64, 10 x 64 flash launches; every R² and ρ finite),
   ``probe_next_token --npz`` on the block-512 validation split (the decode
   kernel 10 for its one cached step, the flash forward 10 a microbatch of
   32), and the five label tools on the demo records (the motif audit over
   a ``synthetic_hairpin`` consensus, which it must flag, and a poly-T
   cluster). Then the flash forward against its plain version at the
   probes' B 1 x T 25, 33 and 49 (heads of 48, bf16), timed.
57. classifiers — a second worker process started beside phase 56's
   (``classifiers_worker``, one host thread), joined here. ``mine_motifs``
   at its defaults (``--n_clusters`` 100, 256 rows, ``--device cuda``) on
   the demo run: the flash forward n_layer times, the port's KMeans
   (``evals/clustering.py``) over the pass's ~85,000 windows; 100
   non-empty clusters whose sizes sum to the windows, the fit's inertia at
   most its k-means++ start's, every window's float64 relabelling against
   the final centres equal to the fit's labels but for float32 ties
   (counted, ``MOTIF_TIE_FACTOR``), its seconds and iterations logged
   (``[motifs_clustering]``); ``MotifClusterer(method="hdbscan",
   pca_components=16)`` on the first 2,000 windows: clusters of at least
   ``min_cluster_size``, the PCA's components orthonormal within 1e-5.
   Then on the first 720 demo records of phase 29, labelled in three GC3
   tertiles: ``extract_embeddings`` train (480) and test (240) packs with
   the dataset manifest (the flash forward 10 a batch of 64),
   ``train_classifier`` with ``probe_logreg``, ``probe_svm`` (verified
   provenance), ``kmer_logreg`` and ``kmer_svm`` (packs with sequences),
   ``eval_classifier`` on each pickle (its report equal to the train CLI's
   test report), ``probe_linear`` logreg and svm, ``benchmark_xgboost_dna``
   on the same genes (the port's multiclass booster), and
   ``probe_ss_linear`` on the final hidden states of 64 genes (one batch:
   the flash forward 10 times) with ``ss_propensity``'s H/E/C of each
   codon's residue; every report finite, the classes not predicted listed
   (``[classifiers]``).

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's measured numbers; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA it prints no result and exits 1.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import copy
import csv
import dataclasses
import functools
import hashlib
import http.client
import io
import json
import math
import os
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
from genomics_lm_torch.evals.benchmark_xgboost_dna import PORT_ENGINE as PORT_XGB_ENGINE
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
from genomics_lm_torch.parallel import workers as par_workers
from genomics_lm_torch.parallel import launch as par_launch
from genomics_lm_torch.serving import benchmark_decode_kernel as bench_decode
from genomics_lm_torch.serving import benchmark_serving as bench_serving
from genomics_lm_torch.serving import benchmark_speculative as bench_spec
from genomics_lm_torch.serving import speculative as spec_mod
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
from genomics_lm_torch.training import engine as engine_lib
from genomics_lm_torch.training import lora as lora_lib
from genomics_lm_torch.training import profile_step as train_main
from genomics_lm_torch.training.checkpoints import load_checkpoint, load_checkpoint_meta
from genomics_lm_torch.data.datasets import EpochPlan, PackedDataset
from genomics_lm_torch.data.genbank import reverse_complement as dna_reverse_complement
from genomics_lm_torch.models.biophysics import ShapeEncoder, shape_lookup_table
from genomics_lm_torch.tokenizers.codon import STOP_IDS, write_itos
from genomics_lm_torch.training.lifecycle import RunLifecycleError
from genomics_lm_torch.training.merge_lora import main as merge_cli
from genomics_lm_torch.training.train_codon_lm import main as train_cli
from genomics_lm_torch.training.train_noprop import main as noprop_cli
from genomics_lm_torch.training.optim import build_optimizer
from genomics_lm_torch.training.runtime import WallTimer
from genomics_lm_torch.training.train_step import LossConfig, make_eval_step, make_train_step
from genomics_lm_torch.utils.sync import hard_sync
from genomics_lm_torch.utils.timing import card_peaks, decode_bound_ms, median_ms
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax, state_dict_from_jax

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
    counts, tokens_per_s, step_ms = {}, {}, {}
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
        step_ms[kv_quant] = seconds * 1e3 / steps
        log("serve", model="10L8H d384 bf16 fused_qkv", kv_quant=kv_quant,
            requests=len(reqs), slots=ENGINE["slots"],
            steps_per_sync=ENGINE["steps_per_sync"],
            delivered_tokens=delivered, seconds=seconds,
            delivered_tokens_per_s=delivered / seconds, decode_steps=steps,
            kernel_launches=launches,
            ms_per_decode_step=seconds * 1e3 / steps,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
    return {"model": model, "cfg": cfg, "launches": counts[False],
            "launches_int8": counts[True], "tokens_per_s": tokens_per_s,
            "ms_per_decode_step": step_ms}


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


def flash_case(gen, B, Hq, Hkv, T, S, D, dtype, window, rate, causal=True, segs=97,
               heads=None):
    """Random q, k, v, segment ids, seed, config. ``segs``: a <SEP> every
    ``segs``-th token (running count, as the main path's batches),
    "random": ids drawn from {0..3}, not monotone, or a (B, S) tensor of
    real windows' ids. ``heads``: the
    ``dropout_heads`` (h0, H) of a tensor-parallel rank."""
    dev = "cuda"
    q = torch.randn((B, Hq, T, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    if isinstance(segs, torch.Tensor):  # the (B, S) ids of real windows
        seg = segs.to(device=dev, dtype=torch.int32).contiguous()
    elif segs == "random":
        seg = torch.randint(0, 4, (B, S), generator=gen, device=dev, dtype=torch.int32)
    else:
        seps = (torch.arange(S, device=dev) % segs == 0).to(torch.int32)
        seg = torch.cumsum(seps[None, :].expand(B, S), dim=-1, dtype=torch.int32).contiguous()
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    return q, k, v, seg, seed, fa.FlashCfg(causal, window, rate, heads)


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
                     is_timed, peak_bw, peak_ops, heads=None) -> dict | None:
    """One flash case: the forward, dQ and dK/dV kernels (through the
    autograd Function, a fixed random cotangent) against their plain
    versions within ``FLASH_TOL``; when ``is_timed``, then each kernel's
    time beside its bound (bf16 operations over the bf16 peak, float32 over
    the float32 SIMT peak), its plain version's and SDPA's, as
    ``{"fwd"|"dq"|"dkv": {...}}``."""
    bf16 = torch.bfloat16
    causal = "noncausal" not in name
    q, k, v, seg, seed, cfg = flash_case(gen, b, hq, hkv, t, s_len, d, dtype, window, rate,
                                         causal, segs, heads)
    live = fa.flash_live_tiles(seg, t, s_len, causal, window)
    band = fa.flash_live_tiles(None, t, s_len, causal, window)
    tiles = dict(band_tiles=int(band.sum()) * b * hq)
    # the bf16 kernels skip dead tiles; the float32 kernels visit the band
    tiles["tiles_visited"] = int(live.sum()) * hq if dtype == bf16 else tiles["band_tiles"]
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, segment_ids=seg, attention_window=window,
                             dropout_rate=rate, seed=seed, causal=causal, dropout_heads=heads)
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
        dropout=rate, dropout_heads=heads,
        segments="from the windows" if isinstance(segs, torch.Tensor) else segs, **tiles,
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
    return dict(launches, nonpad_tokens_per_s=nonpad * measured / seconds)


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
PIPELINE_DEPTH = dict(measure=1, profile_groups=1)  # measured groups cut for time


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
    args = bench_spec.parser().parse_args(["--repeats", "1"])  # a cut for time
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

REMAT_TIMED_GROUPS = 1  # timed groups each way, cut from 3 for time
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


INT8_DRAIN_ORDER = ("dense", "int8")  # one pair of dense, int8, int8, dense: a cut for time
# the int8 drains' requests: the first 72 of phase 4's 128, 8 more than the 64
# slots, so slots refill (a cut for time)
INT8_DRAIN_REQUESTS = 72
# the draft tables of the int8-weight and MoE speculative drains: fitted to 64 sampled tokens
# of benchmark_serving's 256 (a cut for time; [spec_serve] keeps 256): the MoE run's
# 256 cached steps at 12 layers took 9.8 s of [moe_serve]
DRAFT_TOKENS_CUT = 64
INT8_BENCH_REQUESTS = 72  # benchmark_serving's requests (cut for time from 256 closed
# loop and 128 open loop; more than its 64 slots, so slots are refilled)


def phase_int8_serve(served: dict, card: str) -> dict:
    """The serving main path with weight-only int8 block linears: the dense
    model of phase 4, quantized by ``quantize_params``, drains the first
    ``INT8_DRAIN_REQUESTS`` of phase 4's requests with a bf16 and an int8
    cache, as the dense model does; then a speculative drain, the
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
    reqs = build_requests(rng, REQUESTS)[:INT8_DRAIN_REQUESTS]  # of phase_serve's
    drain(model, cfg, warm, False)
    counts = {}
    for kv_quant in (False, True):
        # dense, then int8 on the same requests (one pair, cut from two for
        # the smoke's time; the host drifts within a call)
        runs = {"dense": [], "int8": []}  # (seconds, delivered tokens) of each drain
        for name in INT8_DRAIN_ORDER:
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
            kv_quant=kv_quant, requests=len(reqs), order=", ".join(INT8_DRAIN_ORDER),
            int8_tokens_per_s=tps["int8"], dense_tokens_per_s=tps["dense"],
            int8_over_dense=mean["int8"] / mean["dense"],
            phase4_dense_delivered_tokens_per_s=served["tokens_per_s"][kv_quant],
            decode_steps=steps, kernel_launches=counts[kv_quant],
            ms_per_decode_step_int8=[t * 1e3 / steps for t, _ in runs["int8"]],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, **bytes_row, card=card)

    spec = dict(speculative_k=SPECULATIVE_K,
                draft_table=fit_draft_table(model, cfg, tokens=DRAFT_TOKENS_CUT))
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
    for name, argv in (("closed_loop", ["--int8_weights", "--repeats", "1", "--requests",
                                        str(INT8_BENCH_REQUESTS)]),
                       ("open_loop", ["--int8_weights", "--arrival_rate", "40",
                                      "--requests", str(INT8_BENCH_REQUESTS)])):
        t0 = time.perf_counter()
        reports[name] = bench_serving.run(bench_serving.parser().parse_args(argv))
        print(json.dumps({k: v for k, v in reports[name].items() if k != "ttft_ms"}),
              flush=True)
        log("int8_benchmark_serving", protocol=name, seconds=time.perf_counter() - t0,
            value=reports[name]["value"], unit=reports[name]["unit"], card=card)
    if len(reports["open_loop"]["ttft_ms"]) != INT8_BENCH_REQUESTS:
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
MOE_GROUPS_PER_EPOCH = 1  # cut from 2 for the smoke's time
MOE_EPOCHS = 2  # the run's epochs and the straight run's: cut from 3 for the smoke's time
MOE_VAL_WINDOWS = 64
MOE_PARAMS, DENSE_PARAMS = 113_740_800, 38_126_592  # counted from JAX init's shapes
MOE_PARITY_CAPACITY = 0.5  # about half the choices drop: a wrong slot order shows
# a (token, rank) choice may flip between the card and the CPU only where the
# competing experts' probabilities lie within float32 rounding of each other
MOE_NEAR_TIE = 1e-6
EMBED_F32_ATOL = 1e-4
EMBED_WINDOWS = 64
MOE_CPU_WINDOWS = 2  # validation windows of 512 scored on both devices (12L d512 on the CPU)


def recipe_yaml(source: Path, tag: str, workdir: Path, name: str, **overrides) -> Path:
    """A shipped recipe (``source``, read, never edited) with the phase's
    data paths, run id (default ``name``) and ``overrides``, written into
    ``workdir`` as ``name``; each override is logged under ``tag``."""
    import yaml

    cfg = yaml.safe_load(source.read_text())
    overrides = dict(dict(train_npz=str(workdir / "train.npz"),
                          val_npz=str(workdir / "val.npz"), run_id=name), **overrides)
    log(tag, config=name, source=source.name,
        overrides={k: {"recipe": cfg.get(k), "here": v} for k, v in overrides.items()})
    cfg.update(overrides)
    path = workdir / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def moe_yaml(workdir: Path, name: str, **overrides) -> Path:
    """``configs/stage2.6_moe_4e_top2_d512_ep2.yaml`` with the phase's data
    paths, epochs, run id and schedule (``recipe_yaml``)."""
    return recipe_yaml(MOE_CONFIG, "moe_config", workdir, name, **overrides)


def route_aux(kwargs: dict, route: dict):
    """For ``recorded_routes``: the router loss of a call that computes one."""
    return None if route["aux"] is None else route["aux"].detach()


def route_on_host(kwargs: dict, route: dict) -> dict:
    """For ``recorded_routes``: a call's whole result on the host."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in route.items()}


def tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def phase_moe_train(card: str, workdir: Path) -> dict:
    """The MoE config through the train CLI: ``MOE_EPOCHS`` - 1 epochs of
    ``MOE_GROUPS_PER_EPOCH`` groups and a resume to one more, beside a
    straight ``MOE_EPOCHS``-epoch run; the run stays in ``workdir``."""
    runs = workdir / "runs"
    batch, gacc = 8, 16  # the config's
    packed_corpus(workdir, MOE_GROUPS_PER_EPOCH * batch * gacc, MOE_VAL_WINDOWS)
    short = dict(warmup_steps=1, scheduler_total_steps=MOE_EPOCHS * MOE_GROUPS_PER_EPOCH)
    cfg_path = moe_yaml(workdir, "smoke-moe", epochs=MOE_EPOCHS - 1, **short)
    straight_path = moe_yaml(workdir, "smoke-moe-straight", epochs=MOE_EPOCHS, **short)
    run_dir = runs / "smoke-moe"
    last = run_dir / "checkpoints" / "last.npz"
    argv = ["--config", str(cfg_path), "--run_root", str(runs)]
    for w in FLASH_WRAPPERS:
        w.launches = 0  # the MoE path's runs only: 2 epochs and the resume
    torch.cuda.reset_peak_memory_stats()
    stdout = io.StringIO()
    with par_workers.recorded_routes(route_aux) as auxes, contextlib.redirect_stdout(stdout):
        t0 = time.perf_counter()
        rc = train_cli(argv)
        first_s = time.perf_counter() - t0
        cfg_path.write_text(cfg_path.read_text().replace(f"epochs: {MOE_EPOCHS - 1}",
                                                         f"epochs: {MOE_EPOCHS}"))
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
    if any(out["rc"]) or len(rows) != MOE_EPOCHS or groups != MOE_EPOCHS * MOE_GROUPS_PER_EPOCH:
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
        with par_workers.recorded_routes(route_on_host) as got, torch.no_grad():
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


MOE_SERVE_REQUESTS = 72  # of phase 4's 128, a cut for time: 8 more than the 64
# slots, so retired requests' slots are refilled


def phase_moe_serve(moe_run: dict, card: str, peak_bw, peak_ops) -> dict:
    model, cfg, itos, _ = load_codon_model(moe_run["run_dir"], device="cuda")
    cfg = cfg.replace(dropout=0.0)
    rng = np.random.default_rng(0)
    drain(model, cfg, build_requests(rng, 8), kv_quant=False)  # warm-up
    reqs = build_requests(rng, REQUESTS)[:MOE_SERVE_REQUESTS]  # [serve]'s mix, a cut
    da.decode_attention.launches = 0  # the MoE serving path's drain only
    results, seconds, eng = drain(model, cfg, reqs, kv_quant=False)
    decode_launches = da.decode_attention.launches
    steps = eng.stats()["decode_steps"]
    delivered = sum(len(r.tokens) for r in results.values())
    dense_tps = delivered / seconds
    spec = dict(speculative_k=SPECULATIVE_K,
                draft_table=fit_draft_table(model, cfg, tokens=DRAFT_TOKENS_CUT))
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


MOE_THROUGHPUT_TOP_KS = (2,)  # of the CLI's top-1 and top-2: one subprocess fewer
# depth cuts for the smoke's time: the candidates and the profiled MoE group at 4 of
# the recipe's 12 layers, the candidates' groups of 4 microbatches (of 16); the profile's
# trace holds a third of the events, and torch.profiler's key_averages() over them took
# 28 s of the phase's 110 s at 12 layers
MOE_THROUGHPUT_LAYERS = 4
MOE_THROUGHPUT_G = 4


def phase_moe_throughput(card: str) -> dict:
    """``benchmark_moe``'s throughput section (dense and top-2, 1 measured
    group each, a subprocess each; top-1 cut for the smoke's time), then one
    profiled MoE group split by part."""
    import types

    args = types.SimpleNamespace(**{a.dest: a.default for a in bench_moe.parser()._actions
                                    if a.dest != "help"})
    args.measure_steps = 1
    with contextlib.redirect_stdout(io.StringIO()):
        report = bench_moe.run_throughput(
            args, model=dict(bench_moe.D512_MODEL, n_layer=MOE_THROUGHPUT_LAYERS),
            grad_accum=MOE_THROUGHPUT_G, top_ks=MOE_THROUGHPUT_TOP_KS)
    rc = 0
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
        train_main.main(["--moe", "--groups", "1", "--top", "12",
                         "--n_layer", str(MOE_THROUGHPUT_LAYERS)])
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


MOE_QUALITY_EPOCHS = 1  # of the script's 12, for the smoke's time
MOE_QUALITY_LAYERS = 3  # of the script's 6, for the smoke's time
MOE_QUALITY_GENES = 400  # of the script's 800-gene corpus, for the smoke's time


def phase_moe_quality(card: str) -> dict:
    """``python -m genomics_lm_torch.training.benchmark_moe --skip_throughput
    --converged_epochs 0``: the script's widths (4 heads, d256, block 256, B
    16, lr 1e-3) for 1 of its 12 epochs at 3 of its 6 layers on 400 of its
    800 demo genes; the 30-epoch converged pass is cut."""
    with tempfile.TemporaryDirectory(prefix="smoke_moe_quality_") as tmp:
        out = Path(tmp) / "moe_quality.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "genomics_lm_torch.training.benchmark_moe",
             "--skip_throughput", "--converged_epochs", "0", "--epochs", str(MOE_QUALITY_EPOCHS),
             "--n_layer", str(MOE_QUALITY_LAYERS), "--genes", str(MOE_QUALITY_GENES),
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
        cut=f"{MOE_QUALITY_EPOCHS} of 12 epochs, {MOE_QUALITY_LAYERS} of 6 layers, "
            f"{MOE_QUALITY_GENES} of 800 genes; the 30-epoch converged pass", card=card)
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
PREFIX_GENES = 1  # of the quick preset's 10, for the smoke's time
DESIGN_CPU = ["--n_candidates", "1", "--budget", "600"]  # the CPU run's cut of the defaults
# the card's design loops: 2 of the default 8 candidates (a cut for time; it was 4)
DESIGN_CUT = ["--n_candidates", "2"]


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
    """The motif pass of ``mine_motifs`` on the demo run (``phase_demo_run``) over
    the block-512 demo train split's first 256 rows, in process: one
    ``hidden_states`` pass (the flash forward n_layer times), the window
    embeddings pooled on the card, timed; float32 on the card against the CPU;
    the flash forward at the pass's shape. The CLI itself, with its clustering
    (host seconds), runs in the classifiers worker (``classifiers_worker``)."""
    from genomics_lm_torch.evals.motifs import extract_window_embeddings

    run_dir, train_npz = trained["run_dir"], data / "train_bs512.npz"
    model, cfg, _, _ = load_codon_model(run_dir, device="cuda")
    cfg = cfg.replace(dropout=0.0)
    ds = PackedDataset(str(train_npz))
    x, _ = ds.fetch_batch(list(range(min(len(ds), MOTIF_ROWS))))
    fa.flash_fwd.launches = 0  # the motif pass only
    t0 = time.perf_counter()
    emb, meta = extract_window_embeddings(model, cfg, x, exclude_ids=[0])
    extract_seconds = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
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
               embedding_mb=emb.nbytes / 1e6, extract_seconds=extract_seconds,
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
            str(PREFIX_SAMPLES), "--max_genes", str(PREFIX_GENES), "--k_list", PREFIX_K_LIST,
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
    """``generative_design_loop`` at its defaults but ``DESIGN_CUT``'s 4
    candidates, with ``--esm_fold_top 2 --fold_backend mock`` on the demo run:
    seconds, tokens spent, the
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
    for device, extra in (("cuda", DESIGN_CUT), ("cpu", DESIGN_CPU)):
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


# --- the decode kernel under load (ROADMAP.md §3) -------------------------------

DECODE_STRESS_DRAWS = 50
DECODE_STRESS_DIR = Path("decode_stress_failures")  # git-ignored


def phase_decode_stress(draws: int = DECODE_STRESS_DRAWS) -> dict:
    """``[kernel]``'s ``main_bf16`` case (L 10, B 64, S 256, 8 kv heads of 48,
    random lengths) on ``draws`` fresh draws, each on all 10 layers and again
    with NaN in the dead tiles, while a second stream runs 8192² bf16
    products, so the kernel runs under load. On an error over
    ``KERNEL_ATOL`` it prints the draw's seed and the first (layer, slot,
    head) that is off, saves the draw's tensors under ``DECODE_STRESS_DIR``
    and fails."""
    L, B, S, Hkv, G, D = 10, 64, 256, 8, 1, 48
    bf16 = torch.bfloat16
    side = torch.cuda.Stream()
    a = torch.randn((8192, 8192), device="cuda", dtype=bf16)
    load_products = 0
    worst = worst_nan = 0.0
    t0 = time.perf_counter()
    for draw in range(draws):
        seed = 5000 + draw
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, mask, _, _ = make_case(gen, L, B, S, Hkv, G, D, bf16, bf16, "random")
        pk, pv, _, _ = poison_dead_tiles(k, v, None, None, mask)
        torch.cuda.synchronize()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                a @ a
                load_products += 1
        for layer in range(L):
            want = da.decode_attention_reference(q, k, v, mask, layer, kv_heads=Hkv).float()
            for label, kk, vv in (("plain", k, v), ("nan_dead_tiles", pk, pv)):
                got = da.decode_attention(q, kk, vv, mask, layer, kv_heads=Hkv).float()
                bad = ~torch.isfinite(got) | ((got - want).abs() > KERNEL_ATOL)
                err = max_err(got, want)
                if label == "plain":
                    worst = max(worst, err)
                else:
                    worst_nan = max(worst_nan, err)
                if bool(bad.any()):
                    slot, head, _ = (int(i) for i in bad.nonzero()[0])
                    DECODE_STRESS_DIR.mkdir(parents=True, exist_ok=True)
                    path = DECODE_STRESS_DIR / f"draw_seed{seed}.pt"
                    torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "mask": mask.cpu(),
                                "layer": layer, "got": got.cpu(), "want": want.cpu(),
                                "case": label}, path)
                    log("decode_stress", failed=True, seed=seed, case=label, layer=layer,
                        slot=slot, head=head, max_abs_err=err, saved=str(path))
                    raise AssertionError(
                        f"decode kernel off on draw seed {seed} ({label}): layer {layer}, "
                        f"slot {slot}, head {head}, max error {err}")
        torch.cuda.synchronize()
    row = dict(draws=draws, layers=L, shape=dict(L=L, B=B, S=S, Hkv=Hkv, D=D),
               seeds=[5000, 5000 + draws - 1], max_abs_err=worst, nan_dead_tiles_err=worst_nan,
               tol=KERNEL_ATOL, load="8192x8192 bf16 products on a second stream",
               load_products=load_products, seconds=time.perf_counter() - t0)
    log("decode_stress", **row)
    del a
    return row


# --- phases 38-41: the protein-critic stack -------------------------------------

PROTEIN_CONFIG = Path(__file__).resolve().parent / "configs" / "protein_critic_12L8H.yaml"
PROTEIN_CORPUS = ["--genes", "800", "--min_codons", "50", "--max_codons", "510",
                  "--seed", "1337"]
PROTEIN_CRITIC_EPOCHS = 1  # of the config's 10, then a resume to a second
PROTEIN_LM_EPOCHS = 1
PROTEIN_EBM_EPOCHS = 2  # of train_ebm's 5
PROTEIN_HEADS_EPOCHS = 3  # of train_mlp_heads' 20
PROTEIN_CPU_LATENTS = 16  # validation proteins whose latents run on both devices
PROTEIN_PARITY_LAYERS = 2
LANGEVIN_CPU_STEPS = 5
# eval_generation_prefix under the critic: 1 gene (of the quick preset's 10),
# k 1 and 10 (of 1, 3, 5, 10), 1 sample (of 2)
CRITIC_GUIDED_CUT = ["--preset", "quick", "--max_genes", "1", "--k_list", "10",
                     "--samples", "1"]


def protein_records(workdir: Path) -> dict:
    """The demo corpus at ``PROTEIN_CORPUS``, each gene translated to
    protein, labelled and split by genome: ``pfam_id`` the genus (4
    classes), ``ec_id`` a seeded 5-class label, ``stability_score`` a seeded
    normal with 20% missing (NaN targets), ``go_terms`` a seeded 8-way
    multi-label vector; genome 2 of every genus is the validation split, so
    every genus is in both. Logs the record count, lengths and bucket widths."""
    from genomics_lm_torch.data.demo_corpus import main as corpus_cli
    from genomics_lm_torch.data.leakage import translate_cds
    from genomics_lm_torch.protein.dataset import (
        MultiTaskProteinDataset,
        length_bucket_batches,
        pad_width_for,
    )
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer

    workdir.mkdir(parents=True, exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        corpus_cli(["--out", str(workdir / "records.tsv"), *PROTEIN_CORPUS])
    with (workdir / "records.tsv").open() as f:
        records = list(csv.DictReader(f, delimiter="\t"))
    rng = np.random.default_rng(1337)
    splits = {"train": [], "val": []}
    for r in records:
        stability = float(rng.normal())
        row = {"id": r["source_id"], "sequence": translate_cds(r["sequence"]),
               "pfam_id": int(r["genus"].removeprefix("genus")),
               "ec_id": int(rng.integers(0, 5)),
               "stability_score": None if rng.random() < 0.2 else stability,
               "go_terms": [int(x) for x in (rng.random(8) < 0.3)]}
        splits["val" if r["genome"].endswith("genome2") else "train"].append(row)
    paths = {}
    for name, rows in splits.items():
        paths[name] = workdir / f"{name}.jsonl"
        paths[name].write_text("".join(json.dumps(r) + "\n" for r in rows))
    ds = MultiTaskProteinDataset(paths["train"], ProteinTokenizer(), max_length=512)
    widths = sorted({pad_width_for([ds.sequence_length(i) for i in rows])
                     for rows in length_bucket_batches(ds, 16, seed=1337, epoch=1)})
    lengths = [len(r["sequence"]) for rows in splits.values() for r in rows]
    log("protein_data", records=len(records), train=len(splits["train"]),
        val=len(splits["val"]), residues=dict(min=min(lengths), max=max(lengths),
                                              median=int(np.median(lengths))),
        bucket_widths=widths, genera=sorted({r["pfam_id"] for r in splits["val"]}))
    if widths[-1] != 512 or len({r["pfam_id"] for r in splits["val"]}) != 4:
        raise AssertionError(f"protein records: widths {widths}")
    return {"dir": workdir, **paths}


def protein_model_cfg():
    """The critic's model config at ``PROTEIN_CONFIG``'s widths, dropout 0."""
    import yaml

    from genomics_lm_torch.models.protein import ProteinClassifierConfig

    cfg = yaml.safe_load(PROTEIN_CONFIG.read_text())
    return ProteinClassifierConfig(
        vocab_size=28, n_layer=int(cfg["n_layer"]), n_head=int(cfg["n_head"]),
        n_embd=int(cfg["n_embd"]), block_size=int(cfg["block_size"]), dropout=0.0,
        pooling=str(cfg["pooling"]), bidirectional=bool(cfg["bidirectional"]))


def _protein_yaml(path: Path, **overrides) -> Path:
    import yaml

    cfg = yaml.safe_load(PROTEIN_CONFIG.read_text())
    cfg.update(overrides)
    path.write_text(yaml.safe_dump(cfg))
    return path


def _critic_step_parity(data: dict, card: str) -> dict:
    """One float32 AdamW step of a ``PROTEIN_PARITY_LAYERS``-layer critic at
    the config's width from one JAX-layout tree, on the card (TF32 off) and
    on the CPU, over one length bucket of the training split, held to
    ``TRAIN_PARITY_TOL``."""
    import yaml

    from genomics_lm_torch.models import protein as pm
    from genomics_lm_torch.protein import common
    from genomics_lm_torch.protein.dataset import (
        MultiTaskProteinDataset,
        length_bucket_batches,
        pad_width_for,
    )
    from genomics_lm_torch.protein.train_multi_task import (
        critic_config,
        critic_objective,
        infer_task_dims,
    )
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
    from genomics_lm_torch.utils.weights import protein_params_from_jax, protein_params_to_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = yaml.safe_load(data["yaml"].read_text())
    ds = MultiTaskProteinDataset(data["train"], ProteinTokenizer(), max_length=512,
                                 multi_label_tasks=cfg["multi_label_tasks"])
    dims = infer_task_dims(ds, cfg)
    mcfg = dataclasses.replace(critic_config(cfg, 28), n_layer=PROTEIN_PARITY_LAYERS,
                               dropout=0.0)
    tree = protein_params_to_jax(pm.init_weights(pm.MultiTaskProteinCritic(mcfg, dims), 5))
    buckets = {pad_width_for([ds.sequence_length(i) for i in r]): r
               for r in length_bucket_batches(ds, 16, seed=1337, epoch=1)}
    width = 128 if 128 in buckets else min(buckets)
    host = ds.batch(buckets[width], pad_to=width)
    out = {}
    for device in ("cuda", "cpu"):
        model = protein_params_from_jax(tree, "multitask", mcfg, device).train()
        objective = critic_objective(cfg, ds, dims, mcfg, device)
        opt = common.adamw(model, float(cfg["lr"]), float(cfg["weight_decay"]))
        loss, _ = objective(model, common.batch_to_device(host, device), True)
        loss.backward()
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().clone()
                 for n, p in model.named_parameters()}
        common.apply_accumulated(opt)
        out[device] = (float(loss.detach()), grads,
                       {n: p.detach().cpu() for n, p in model.named_parameters()})
    (lc, gc_, pc), (lw, gw, pw) = out["cuda"], out["cpu"]
    tol = TRAIN_PARITY_TOL
    top = max(float(g.abs().max()) for g in gw.values())
    grad_err = param_err = noise_err = 0.0
    for name in gw:
        # a leaf's error over its largest gradient, floored as phase 9 does
        scale = max(float(gw[name].abs().max()), 1e-3 * top)
        grad_err = max(grad_err, float((gc_[name] - gw[name]).abs().max()) / scale)
        noisy = gw[name].abs() < tol["noise_grad_share"] * top
        err = (pc[name] - pw[name]).abs()
        param_err = max(param_err, float(torch.where(noisy, 0.0, err).max()))
        noise_err = max(noise_err, float(torch.where(noisy, err, 0.0).max()))
    row = dict(layers=PROTEIN_PARITY_LAYERS, batch=list(host["input_ids"].shape),
               loss_card=lc, loss_cpu=lw, loss_rel=abs(lc - lw) / abs(lw),
               grad_rel=grad_err, param_abs=param_err, noise_param_abs=noise_err, tol=tol)
    log("protein_critic_parity", **row, card=card)
    if (row["loss_rel"] > tol["loss_rtol"] or grad_err > tol["grad_rtol"]
            or param_err > tol["param_atol"] or noise_err > tol["noise_param_atol"]):
        raise AssertionError(f"critic step card against CPU: {row}")
    return row


def _profile_critic_group(data: dict, card: str) -> dict:
    """``torch.profiler`` over one training group (2 microbatches of B 16 at
    the 512-wide bucket, AdamW) of the full-width critic: wall and device ms,
    busy share, kernel launches and the top operations by device time."""
    import yaml

    from genomics_lm_torch.models import protein as pm
    from genomics_lm_torch.protein import common
    from genomics_lm_torch.protein.dataset import (
        MultiTaskProteinDataset,
        length_bucket_batches,
        pad_width_for,
    )
    from genomics_lm_torch.protein.train_multi_task import (
        critic_config,
        critic_objective,
        infer_task_dims,
    )
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
    from genomics_lm_torch.training.profile_step import _device_us

    cfg = yaml.safe_load(data["yaml"].read_text())
    ds = MultiTaskProteinDataset(data["train"], ProteinTokenizer(), max_length=512,
                                 multi_label_tasks=cfg["multi_label_tasks"])
    dims = infer_task_dims(ds, cfg)
    mcfg = critic_config(cfg, 28)
    model = pm.init_weights(pm.MultiTaskProteinCritic(mcfg, dims), 0).cuda().train()
    objective = critic_objective(cfg, ds, dims, mcfg, "cuda")
    opt = common.adamw(model, float(cfg["lr"]), float(cfg["weight_decay"]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    wide = [r for r in length_bucket_batches(ds, 16, seed=1337, epoch=1)
            if pad_width_for([ds.sequence_length(i) for i in r]) == 512][:2]
    batches = [common.batch_to_device(ds.batch(r, pad_to=512), "cuda") for r in wide]

    def group():
        for b in batches:
            objective(model, b, True, gen)[0].backward()
        common.apply_accumulated(opt, len(batches))
        torch.cuda.synchronize()

    group()  # warm-up
    t0 = time.perf_counter()
    group()
    plain_s = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        group()
        prof_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in kernels)
    def op_us(e):  # device time of the kernels an operation launched
        return float(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))

    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::") and op_us(e) > 0]
    row = dict(group=f"2 x B 16 x T 512, {mcfg.n_layer}L{mcfg.n_head}H d{mcfg.n_embd} float32",
               ms_per_group=plain_s * 1e3, profiled_ms=prof_s * 1e3,
               device_ms=device_us / 1e3, device_busy_share=device_us / 1e6 / plain_s,
               kernel_launches=sum(e.count for e in kernels),
               top_kernels=[{"kernel": e.key[:80], "launches": e.count,
                             "device_ms": _device_us(e) / 1e3}
                            for e in sorted(kernels, key=_device_us, reverse=True)[:8]],
               top_ops=[{"op": e.key, "calls": e.count, "device_ms": op_us(e) / 1e3}
                        for e in sorted(ops, key=op_us, reverse=True)[:8]])
    log("protein_critic_profile", **row, card=card)
    if device_us <= 0:
        raise AssertionError("the critic group's trace holds no device time")
    del model, opt, batches
    return row


def _run_cli(main_fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__} exited {rc}: {buf.getvalue()[-400:]}")
    return buf.getvalue()


def phase_protein_critic(workdir: Path, card: str) -> dict:
    """The multi-task critic at ``configs/protein_critic_12L8H.yaml`` (as is,
    plus the data paths, its commented ``multi_label_tasks: [go_terms]`` and
    ``task_loss_weights`` lines and a ``task_dims`` entry for the go_terms
    head; each override logged) through the ``train_multi_task`` CLI for
    ``PROTEIN_CRITIC_EPOCHS`` epochs, then ``--resume`` to one more:
    every loss finite, one ``curves.csv`` row an epoch, seconds, sequences/s and peak
    memory per epoch. Then one float32 step of a 2-layer critic card against
    CPU, the trained critic's latents card against CPU, the training
    benchmark at its defaults and at the config's width, and a profiled
    group."""
    from genomics_lm_torch.models import protein as pm
    from genomics_lm_torch.protein.benchmark_protein_critic_training import main as bench_cli
    from genomics_lm_torch.protein.dataset import MultiTaskProteinDataset
    from genomics_lm_torch.protein.train_multi_task import main as critic_cli
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
    from genomics_lm_torch.utils.weights import protein_params_from_jax

    data = protein_records(workdir / "data")
    overrides = dict(train_data=str(data["train"]), val_data=str(data["val"]),
                     multi_label_tasks=["go_terms"], task_dims={"go_terms": 8},
                     task_loss_weights={"family": 1.0, "function": 1.0, "stability": 0.5},
                     epochs=PROTEIN_CRITIC_EPOCHS, run_id="smoke-critic")
    data["yaml"] = _protein_yaml(workdir / "critic.yaml", **overrides)
    runs = workdir / "runs"
    t0 = time.perf_counter()
    printed = _run_cli(critic_cli, ["--config", str(data["yaml"]), "--run_root", str(runs),
                                    "--device", "cuda"])
    run_dir = runs / "smoke-critic"
    last = run_dir / "checkpoints" / "last_critic.npz"
    resume_yaml = _protein_yaml(workdir / "critic_resume.yaml",
                                **dict(overrides, epochs=PROTEIN_CRITIC_EPOCHS + 1))
    printed += _run_cli(critic_cli, ["--config", str(resume_yaml), "--run_root", str(runs),
                                     "--resume", str(last), "--device", "cuda"])
    seconds = time.perf_counter() - t0
    with (run_dir / "scores" / "curves.csv").open() as f:
        curves = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    epochs = []
    for line in printed.splitlines():
        m = re.match(r"\[critic\] epoch (\d+) seconds ([\d.]+) ([\d.]+) seq/s ([\d.]+) res/s "
                     r"peak_memory_bytes (\d+|None)", line)
        if m:
            epochs.append(dict(epoch=int(m[1]), seconds=float(m[2]), seq_per_s=float(m[3]),
                               res_per_s=float(m[4]),
                               peak_memory_bytes=None if m[5] == "None" else int(m[5])))
    row = dict(config=str(PROTEIN_CONFIG.relative_to(PROTEIN_CONFIG.parent.parent)),
               overrides={k: v for k, v in overrides.items() if not k.endswith("_data")},
               curves=curves, epochs=epochs, seconds=seconds)
    log("protein_critic", **row, card=card)
    losses = [v for r in curves for k, v in r.items() if k != "epoch"]
    want = [float(e) for e in range(1, PROTEIN_CRITIC_EPOCHS + 2)]
    if ([r["epoch"] for r in curves] != want or not np.isfinite(losses).all()
            or len(epochs) != len(want)):
        raise AssertionError(f"protein critic run: {row}")

    parity = _critic_step_parity(data, card)
    # the trained critic's latents for PROTEIN_CPU_LATENTS validation proteins
    payload = load_checkpoint(last)
    cfg = protein_model_cfg()
    ds = MultiTaskProteinDataset(data["val"], ProteinTokenizer(), max_length=512)
    host = ds.batch(list(range(PROTEIN_CPU_LATENTS)))
    latents = {}
    for device in ("cuda", "cpu"):
        model = protein_params_from_jax(payload["model"], "multitask", cfg, device)
        with torch.no_grad():
            latents[device] = pm.extract_latent(
                model, cfg, torch.as_tensor(host["input_ids"], device=device),
                torch.as_tensor(host["attention_mask"], device=device)).cpu().numpy()
    rel = card_vs_cpu_rel(latents["cuda"], latents["cpu"])
    log("protein_critic", latents_card_vs_cpu_rel=rel, shape=list(host["input_ids"].shape),
        tol=CARD_CPU_RTOL, tol_reason=CARD_CPU_RTOL_REASON, card=card)
    if rel > CARD_CPU_RTOL or not np.isfinite(latents["cuda"]).all():
        raise AssertionError(f"critic latents card against CPU: {rel}")

    bench = {}
    for name, extra in (("defaults", []),
                        ("config_width", ["--n_layer", str(cfg.n_layer), "--n_head",
                                          str(cfg.n_head), "--n_embd", str(cfg.n_embd)])):
        out = workdir / f"bench_{name}.json"
        _run_cli(bench_cli, ["--jsonl", str(data["train"]), "--out", str(out),
                             "--device", "cuda", *extra])
        bench[name] = json.loads(out.read_text())
    log("protein_critic_benchmark", **bench, card=card)
    profile = _profile_critic_group(data, card)
    return {"data": data, "run_dir": run_dir, "best": run_dir / "checkpoints" /
            "best_critic.npz", "epochs": epochs, "parity": parity, "latents_rel": rel,
            "bench": bench, "profile": profile}


def phase_protein_lm(critic: dict, card: str) -> dict:
    """``train_protein_lm`` at the critic config's widths (12L8H d384, block
    512, dropout 0.1), causal, B 16 x 2 accumulated, lr 1e-4, on the same
    proteins for ``PROTEIN_LM_EPOCHS`` epoch: the loss finite, the
    validation NLL logged."""
    import yaml

    from genomics_lm_torch.protein.train_protein_lm import main as plm_cli

    data = critic["data"]
    workdir = data["dir"].parent
    width = protein_model_cfg()
    config = {"model": {"n_layer": width.n_layer, "n_head": width.n_head,
                        "n_embd": width.n_embd, "block_size": width.block_size,
                        "dropout": 0.1},
              "training": {"epochs": PROTEIN_LM_EPOCHS, "batch_size": 16,
                           "grad_accum_steps": 2, "lr": 1e-4, "weight_decay": 0.01,
                           "seed": 1337},
              "data": {"train_path": str(data["train"]), "val_path": str(data["val"])},
              "run_id": "smoke-plm"}
    (workdir / "plm.yaml").write_text(yaml.safe_dump(config))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    printed = _run_cli(plm_cli, ["--config", str(workdir / "plm.yaml"), "--run_root",
                                 str(workdir / "plm_runs"), "--device", "cuda"])
    seconds = time.perf_counter() - t0
    history = json.loads((workdir / "plm_runs" / "smoke-plm" / "scores" /
                          "metrics.json").read_text())
    losses = [float(line.rsplit(" ", 1)[-1]) for line in printed.splitlines()
              if line.startswith("Epoch") and "Loss:" in line]
    row = dict(config=config["model"], epochs=PROTEIN_LM_EPOCHS, seconds=seconds,
               train_loss_logged=losses, val_nll=[h["val_loss"] for h in history],
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    log("protein_lm", **row, card=card)
    if not losses or not np.isfinite(losses + row["val_nll"]).all():
        raise AssertionError(f"protein LM: {row}")
    return row


def phase_protein_ebm(critic: dict, design_dir: Path, card: str) -> dict:
    """``train_ebm`` on the critic at its defaults (hidden 512, lr 1e-3) for
    ``PROTEIN_EBM_EPOCHS`` epochs; ``optimize_designs_langevin`` on the
    ``[design]`` phase's candidates at its defaults; Langevin card against
    CPU at ``noise_std`` 0 for ``LANGEVIN_CPU_STEPS`` steps (energies within
    ``CARD_CPU_RTOL``, the same projected sequence, the energy history
    finite); then ``train_mlp_heads`` (``PROTEIN_HEADS_EPOCHS`` epochs),
    ``eval_multi_task_critic``, ``extract_protein_embeddings`` and
    ``protein_critic_bridge`` on the validation split and the designs."""
    from genomics_lm_torch.models import protein as pm
    from genomics_lm_torch.protein.eval_multi_task_critic import main as eval_cli
    from genomics_lm_torch.protein.extract_protein_embeddings import main as embed_cli
    from genomics_lm_torch.protein.optimize_designs_langevin import main as langevin_cli
    from genomics_lm_torch.protein.protein_critic_bridge import main as bridge_cli
    from genomics_lm_torch.protein.sampler import latent_langevin_sample
    from genomics_lm_torch.protein.train_ebm import main as ebm_cli
    from genomics_lm_torch.protein.train_mlp_heads import main as heads_cli
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
    from genomics_lm_torch.utils.weights import protein_params_from_jax

    data, best = critic["data"], str(critic["best"])
    workdir = data["dir"].parent
    t0 = time.perf_counter()
    _run_cli(ebm_cli, ["--config", str(data["yaml"]), "--critic_ckpt", best, "--epochs",
                       str(PROTEIN_EBM_EPOCHS), "--run_id", "smoke-ebm", "--run_root",
                       str(workdir / "ebm_runs"), "--device", "cuda"])
    ebm_seconds = time.perf_counter() - t0
    ebm_dir = workdir / "ebm_runs" / "smoke-ebm"
    with (ebm_dir / "scores" / "curves.csv").open() as f:
        curves = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    ebm_ckpt = ebm_dir / "checkpoints" / "best_ebm.npz"
    designs = design_dir / "candidates.csv"
    t0 = time.perf_counter()
    _run_cli(langevin_cli, ["--designs_csv", str(designs), "--critic_ckpt", best,
                            "--ebm_ckpt", str(ebm_ckpt), "--out",
                            str(workdir / "langevin.csv"), "--device", "cuda"])
    langevin_seconds = time.perf_counter() - t0
    with (workdir / "langevin.csv").open() as f:
        optimized = list(csv.DictReader(f))
    energies = [float(r[k]) for r in optimized for k in ("initial_energy", "final_energy")]
    # card against CPU, noise 0, on the first design
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = protein_model_cfg()
    cpay, epay = load_checkpoint(best), load_checkpoint(ebm_ckpt)
    seq = optimized[0]["initial"]
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = latent_langevin_sample(
            protein_params_from_jax(epay["model"], "ebm", None, device),
            protein_params_from_jax(cpay["model"], "multitask", cfg, device), cfg,
            ProteinTokenizer(), seq, steps=LANGEVIN_CPU_STEPS, lr=0.05, noise_std=0.0,
            lambda_reg=0.1)
    rel = card_vs_cpu_rel(out["cuda"][1], out["cpu"][1])
    row = dict(ebm_curves=curves, ebm_seconds=ebm_seconds, designs=len(optimized),
               langevin_seconds=langevin_seconds, langevin_steps=50,
               changed_positions=[int(r["changed_positions"]) for r in optimized],
               energy_first_last=[[float(r["initial_energy"]), float(r["final_energy"])]
                                  for r in optimized],
               langevin_card_vs_cpu_rel=rel, same_sequence=out["cuda"][0] == out["cpu"][0],
               card_energies=out["cuda"][1], tol=CARD_CPU_RTOL)
    log("protein_ebm", **row, card=card)
    if (not optimized or not np.isfinite(energies + out["cuda"][1]).all()
            or not np.isfinite([v for r in curves for v in r.values()]).all()
            or rel > CARD_CPU_RTOL or not row["same_sequence"]):
        raise AssertionError(f"protein EBM: {row}")

    t0 = time.perf_counter()
    heads = json.loads(_run_cli(heads_cli, [
        "--config", str(data["yaml"]), "--critic_ckpt", best, "--epochs",
        str(PROTEIN_HEADS_EPOCHS), "--out_dir", str(workdir / "heads"), "--device", "cuda"]))
    heads_seconds = time.perf_counter() - t0
    evaluated = json.loads(_run_cli(eval_cli, ["--ckpt", best, "--jsonl", str(data["val"]),
                                               "--out", str(workdir / "eval.json"),
                                               "--device", "cuda"]))
    embedded = json.loads(_run_cli(embed_cli, ["--critic_ckpt", best, "--input",
                                               str(data["val"]), "--out",
                                               str(workdir / "emb.npz"), "--device", "cuda"]))
    bridged = json.loads(_run_cli(bridge_cli, ["--dna_csv", str(designs), "--critic_ckpt",
                                               best, "--target_task", "family", "--out",
                                               str(workdir / "bridge.csv"),
                                               "--device", "cuda"]))
    with np.load(workdir / "emb.npz") as f:
        emb_finite = bool(np.isfinite(f["X"]).all())
    log("protein_ebm", heads={t: {"val_accuracy": r.get("val_accuracy")} for t, r in
                              heads.items()}, heads_seconds=heads_seconds,
        eval=evaluated, embeddings=embedded["embeddings"], embeddings_finite=emb_finite,
        bridge=bridged, card=card)
    if not emb_finite or bridged["candidates"] == 0 or not evaluated["tasks"]:
        raise AssertionError("protein critic CLIs")
    return {"ebm": ebm_ckpt, "row": row}


def phase_critic_guided(trained: dict, data: Path, critic: dict, ebm: dict, card: str) -> dict:
    """On the demo run: ``eval_generation_prefix --critic_guidance
    --critic_stability`` and once ``--ebm_guidance`` (each cut to
    ``CRITIC_GUIDED_CUT``), then ``generative_design_loop --critic_ckpt
    --ebm_ckpt --fold_backend mock`` at its defaults but ``DESIGN_CUT``'s 4
    candidates. The critic columns
    present and finite; the decode kernel's launches n_layer x cached steps
    and the flash forward's n_layer x (scored windows + uncached forwards);
    critic forwards per generated codon and their share of the wall time."""
    from genomics_lm_torch.evals import gen_prefix as gp
    from genomics_lm_torch.evals.eval_generation_prefix import main as prefix_cli
    from genomics_lm_torch.generation.generative_design_loop import main as design_cli
    from genomics_lm_torch.protein import critic_scoring as cs

    run_dir = Path(trained["run_dir"])
    model, cfg, _, _ = load_codon_model(run_dir, device="cuda")
    L = cfg.n_layer
    del model
    best, ebm_ckpt = str(critic["best"]), str(ebm["ebm"])
    out = {"decode": 0, "flash": 0}
    runs = {"critic": ["--critic_guidance", "--critic_stability"],
            "ebm": ["--ebm_guidance", "--ebm_ckpt", ebm_ckpt]}
    for name, flags in runs.items():
        label = f"smoke_critic_guided_{name}"
        argv = [str(run_dir), "--npz", str(data / "val_bs512.npz"), "--train_npz",
                str(data / "train_bs512.npz"), *CRITIC_GUIDED_CUT, "--critic_ckpt", best,
                *flags, "--out_label", label, "--device", "cuda"]
        da.decode_attention.launches = 0  # the main path's run only
        fa.flash_fwd.launches = 0
        t0 = time.perf_counter()
        with _Timed(decode_mod, "forward") as uncached, \
                _Timed(decode_mod, "decode_step") as steps, \
                _Timed(gp, "token_nlls", record=lambda dec, ids: len(list(ids))) as nlls, \
                _Timed(gc, "generate_cds_critic_guided") as guided, \
                _Timed(cs, "batch_score_critic") as scored:
            _run_cli(prefix_cli, argv)
        wall = time.perf_counter() - t0
        decode, flash = da.decode_attention.launches, fa.flash_fwd.launches
        forwards = sum(1 for n in nlls.records if n >= 2)
        with (run_dir / "scores" / label / "protocol_samples.csv").open() as f:
            rows = list(csv.DictReader(f))
        guided_rows = [r for r in rows if r["protocol"] == "guided"]
        codons = sum(float(r["gen_len_codons"]) for r in guided_rows)
        critic_scores = [float(r["critic_score"]) for r in rows if r.get("critic_score")]
        row = dict(flags=flags, cut=CRITIC_GUIDED_CUT, samples=len(rows),
                   guided_samples=len(guided_rows), guided_codons=codons,
                   critic_forwards=scored.calls,
                   critic_forwards_per_guided_codon=scored.calls / max(codons, 1),
                   critic_seconds=scored.seconds, critic_share_of_wall=scored.seconds / wall,
                   guided_seconds=guided.seconds, wall=wall,
                   cached_decode_steps=steps.calls, decode_launches=decode,
                   want_decode=L * steps.calls, uncached_forwards=uncached.calls,
                   token_nll_forwards=forwards, flash_fwd_launches=flash,
                   want_flash=L * (forwards + uncached.calls),
                   critic_score_rows=len(critic_scores),
                   guidance=json.loads((run_dir / "scores" / label /
                                        "protocol_manifest.json").read_text())["protocols"][
                                            "guided"]["guidance_components"])
        log("critic_guided", run=name, **row, card=card)
        if (decode == 0 or decode != row["want_decode"] or flash != row["want_flash"]
                or not guided_rows or scored.calls == 0
                or (name == "critic" and (not critic_scores
                                          or not np.isfinite(critic_scores).all()))):
            raise AssertionError(f"critic-guided {name}: {row}")
        out["decode"] += decode
        out["flash"] += flash
        out[name] = row

    da.decode_attention.launches = 0
    fa.flash_fwd.launches = 0
    design_out = run_dir / "scores" / "design_critic"
    t0 = time.perf_counter()
    with _Timed(decode_mod, "decode_step") as steps, _Timed(decode_mod, "forward") as uncached, \
            _Timed(cs, "batch_score_critic") as scored:
        _run_cli(design_cli, [str(run_dir), "--critic_ckpt", best, "--ebm_ckpt", ebm_ckpt,
                              "--fold_backend", "mock", "--out_dir", str(design_out),
                              "--device", "cuda", *DESIGN_CUT])
    seconds = time.perf_counter() - t0
    decode, flash = da.decode_attention.launches, fa.flash_fwd.launches
    with (design_out / "candidates.csv").open() as f:
        cands = list(csv.DictReader(f))
    columns = ("critic_score", "stability_prob", "family_top1", "family_top1_conf",
               "function_top1_conf")
    values = [float(r[c]) for r in cands for c in columns if r.get(c) not in (None, "")]
    summary = json.loads((design_out / "summary.json").read_text())
    report = (design_out / "report.md").read_text()
    row = dict(seconds=seconds, solved=summary["solved"], tokens_spent=summary["tokens_spent"],
               mean_stability_prob=summary.get("mean_stability_prob"),
               critic_forwards=scored.calls, critic_seconds=scored.seconds,
               cached_decode_steps=steps.calls, decode_launches=decode,
               want_decode=L * steps.calls, flash_fwd_launches=flash,
               want_flash=L * uncached.calls,
               critic_columns={c: [r.get(c) for r in cands] for c in columns[:2]},
               report_has_critic_section="## 3. Critic scores" in report)
    log("critic_guided", run="design_loop", **row, card=card)
    if (decode == 0 or decode != row["want_decode"] or flash != row["want_flash"] or not cands
            or len(values) != len(cands) * len(columns) or not np.isfinite(values).all()
            or not row["report_has_critic_section"]):
        raise AssertionError(f"critic design loop: {row}")
    out["decode"] += decode
    out["flash"] += flash
    out["design"] = row
    return out



# --- phases 42-45: data and tensor parallelism, two ranks sharing the card ------
#
# The card machine has one H100 and PyTorch runs one process per device, so
# the parallel paths run as two ranks sharing cuda:0 over gloo (NCCL refuses
# two ranks on one device) and as one rank over NCCL: real collectives and
# the kernels at each rank's shapes, but no scaling figure. The kernels are
# built (phase 2) before any rank is spawned, so no two ranks compile at once.

PARALLEL_TIMEOUT_S = 240  # a rank whose collective waits longer fails the run
# every TP drain but the float32 greedy ones (of 128): the 66 of the smallest
# budgets, 2 more than the 64 slots, so slots refill (a cut for time)
TP_CUT_REQUESTS = 66
# depth cuts for the smoke's time: 1 timed DP group of 3 (its warm-up kept), the
# timed TP group at 4 of bench.py's 16 microbatches (it took 9.3 s at 16)
DP_TIMED_GROUPS = 1
TP_TIMED_G = 4
TP_SERVE_LAYERS = 2  # every TP drain's depth (cut from 10 and 12 for time)
TP_GREEDY_REQUESTS = 4  # the float32 greedy MoE drain's: its smallest budgets (a cut)


def smallest_budgets(reqs: list, n: int) -> list:
    """The ``n`` requests of the smallest budgets, in submission order by budget."""
    return sorted(reqs, key=lambda r: r[1])[:n]


def parallel_model(**over) -> tuple[dict, dict]:
    """(config kwargs, JAX-layout tree) of the training main path's model
    (random weights from its seed), with ``over`` applied."""
    kw = dict(train_main.MAIN_TRAIN, **over)
    cfg = CodonGPTConfig(**kw)
    torch.manual_seed(train_main.SEED)
    return kw, params_to_jax(CodonGPT(cfg), cfg)


def group_spec(kw, tree, axes, groups, *, warmup=0, zero1=True, timed=False) -> dict:
    return {"axes": axes, "model": kw, "tree": tree, "groups": groups, "warmup": warmup,
            "run_cfg": dict(train_main.RUN_CFG, warmup_steps=0, shard_optimizer_state=zero1),
            "total_steps": train_main.TOTAL_STEPS, "time_collectives": timed,
            "return_grads": not timed, "return_tree": not timed, "seed": train_main.SEED}


def spawn_ranks(fn, world: int, *args, backend=None):
    """``fn`` on ``world`` ranks on the card; logs the launch's wall seconds."""
    t0 = time.perf_counter()
    out = par_launch.spawn(fn, world, *args, device="cuda:0", backend=backend,
                           timeout_s=PARALLEL_TIMEOUT_S)
    log("spawn", fn=fn.__name__, world=world, backend=backend or "auto",
        seconds=time.perf_counter() - t0)
    return out


def compare_group(phase: str, name: str, cfg_kw: dict, ref: dict, got: dict, tol: dict,
                  exact: bool = False) -> dict:
    """A parallel run's first group (rank 0's global metrics, full gradient
    and updated weights) against the one-rank card group's: within ``tol``
    (``TRAIN_PARITY_TOL``'s rules), or bit for bit with ``exact``."""
    cfg = CodonGPTConfig(**cfg_kw)
    want_p = state_dict_from_jax(ref["tree"], cfg)
    got_p = state_dict_from_jax(got["tree"], cfg)
    want_g, got_g = ref["grads"], got["grads"]
    gmax = max(float(g.abs().max()) for g in want_g.values())
    loss_ref = ref["metrics"][0]["total_loss_sum"]
    loss_err = abs(got["metrics"][0]["total_loss_sum"] - loss_ref) / abs(loss_ref)
    grad_err = max(float((got_g[n] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * gmax)
                   for n, g in want_g.items())
    param_err = noise_err = 0.0
    for n, g in want_g.items():
        noise = g.abs() < tol["noise_grad_share"] * gmax
        diff = (got_p[n] - want_p[n]).abs()
        param_err = max(param_err, float((diff * ~noise).max()))
        noise_err = max(noise_err, float((diff * noise).max()))
    same = all(torch.equal(got_p[n], want_p[n]) for n in want_p) and all(
        torch.equal(got_g[n], g) for n, g in want_g.items())
    out = dict(case=name, loss=got["metrics"][0]["total_loss_sum"], loss_ref=loss_ref,
               loss_rel_err=loss_err, grad_rel_err=grad_err, param_abs_err=param_err,
               noise_param_abs_err=noise_err, bit_identical=same,
               nonpad_tokens=got["metrics"][0]["nonpad_tokens"],
               nonpad_tokens_ref=ref["metrics"][0]["nonpad_tokens"], tol=tol)
    log(phase + "_parity", **out)
    if exact and not same:
        raise AssertionError(f"{phase} {name}: not bit for bit the one-rank group")
    if (loss_err > tol["loss_rtol"] or grad_err > tol["grad_rtol"]
            or param_err > tol["param_atol"] or noise_err > tol["noise_param_atol"]
            or out["nonpad_tokens"] != out["nonpad_tokens_ref"]):
        raise AssertionError(f"{phase} {name}: disagrees with the one-rank group {out}")
    return out


def log_timed_ranks(phase: str, name: str, ranks: list, nonpad_per_group: int,
                    n_layer: int, groups: int, card: str, G: int = train_main.G) -> dict:
    """Each rank's time, collective share, flash launches per group and
    moment bytes of a timed parallel run; the launches must be G x n_layer
    a group on every rank."""
    rows = []
    for r, res in enumerate(ranks):
        launches = {k: v / groups for k, v in res["launches"].items()}
        rows.append(dict(rank=r, seconds=res["seconds"], setup_seconds=res["setup_seconds"],
                         collective_seconds=res["collective_seconds"],
                         collective_share=res["collective_seconds"] / res["seconds"],
                         collectives=res["collectives"], flash_launches_per_group=launches,
                         moment_bytes=res["state_bytes"]))
        if any(v != G * n_layer for v in launches.values()):
            raise AssertionError(f"{phase} {name}: rank {r} launched {launches} a group, "
                                 f"not G x n_layer = {G * n_layer}")
    seconds = max(res["seconds"] for res in ranks)
    out = dict(case=name, groups=groups, ranks=rows,
               nonpad_tokens_per_s=nonpad_per_group * groups / seconds,
               ms_per_group=seconds * 1e3 / groups, card=card)
    log(phase, **out)
    return out


def prestart_ranks(world: int, calls: list) -> dict:
    """Start a launch of ``world`` ranks of ``workers.each`` now, in a thread:
    each rank starts, joins its group and reaches the card (20-30 s a
    process) while this process goes on, then waits for ``release_ranks``
    before ``calls``. ``stop_ranks`` ends it instead."""
    signal = Path(tempfile.mkdtemp(prefix="smoke_ranks_"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(spawn_ranks, par_workers.each, world,
                         [("wait_for", str(signal))] + calls)
    pool.shutdown(wait=False)
    return {"future": future, "signal": signal}


def release_ranks(started: dict) -> list:
    """Signal a prestarted launch to run its calls; each rank's results."""
    (started["signal"] / "go").touch()
    return [r[1:] for r in started["future"].result()]


def stop_ranks(*launches: dict) -> None:
    """End prestarted launches that have not run (a phase before them failed)."""
    for started in launches:
        (started["signal"] / "stop").touch()


def prepare_parallel_ranks(card: str, workdir: Path) -> dict:
    """The ranks' work of phases 43-48, prestarted (``prestart_ranks``) as
    one launch of two ranks sharing the card over gloo: the data- and
    tensor-parallel float32 parity and timed groups, the train CLI's
    tensor-parallel run, the tensor-parallel drains, and the expert-parallel
    and MoE work (``moe_rank_work``); ``phase_parallel_ranks`` runs it, one
    rank over NCCL beside it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    # float32 parity: the full width at 2 layers (a depth cut), dropout 0,
    # 2 microbatches a group, uneven pad over the ranks' rows
    f32_kw, f32_tree = parallel_model(compute_dtype="float32", dropout=0.0, n_layer=2)
    parity_groups = [tuple(train_main.make_batch(21, "cpu", groups=2)[k].numpy()
                           for k in ("x", "y"))]
    for x, y in parity_groups:
        y[0, 1, 200:] = 0
        y[1, 2, :] = 0
    bf16_kw, bf16_tree = parallel_model()
    sp = {"residual_sharding": ("data", "model")}
    dp_groups = [tuple(train_main.make_batch(s, "cpu")[k].numpy() for k in ("x", "y"))
                 for s in range(DP_TIMED_GROUPS)]
    # TP: 1 timed group of TP_TIMED_G microbatches (the float32 group before it
    # warms the ranks up), each microbatch taking ~0.6 s of gloo collectives
    tp_groups = [tuple(train_main.make_batch(0, "cpu", groups=TP_TIMED_G)[k].numpy()
                       for k in ("x", "y"))]
    tp_axes = {"data": 1, "model": 2}
    # [tp_adafactor]: the TP + SP float32 group under Adafactor, and its
    # one-rank reference in the NCCL process
    ada = {"run_cfg": dict(train_main.RUN_CFG, warmup_steps=0, shard_optimizer_state=False,
                           optimizer="adafactor"), "return_optimizer": True}

    # the train CLI's launch path: --mesh_devices 2 --tensor_parallel 2 at 2
    # layers for 1 epoch (phase 44 resumes it at world size 1 to a second)
    packed_corpus(workdir, 64, 16)
    cfgs = {}
    for epochs in (1, 2):
        cfgs[epochs] = run_yaml(workdir / f"tp_e{epochs}.yaml", workdir / "train.npz",
                                workdir / "val.npz", G=2, epochs=epochs, run_id="tp-run")
        cfgs[epochs].write_text(cfgs[epochs].read_text().replace("n_layer: 10", "n_layer: 2")
                                + "scheduler_total_steps: 8\n")
    cli_argv = ["--run_root", str(workdir / "runs"), "--device", "cuda:0"]

    # serving: phase 4's model at tensor parallel 2, at 2 layers (a depth cut);
    # the float32 parity on the 8 requests of the smallest budgets, every
    # other drain on the 66 of the smallest (2 more than the slots, so slots
    # are refilled): cuts of the 128 for time
    serve_kw = dict(MAIN, n_layer=TP_SERVE_LAYERS)
    cfg = CodonGPTConfig(**serve_kw)
    torch.manual_seed(0)
    model = CodonGPT(cfg).cuda()
    serve_tree = params_to_jax(model, cfg)
    table = fit_draft_table(model, cfg)
    del model
    reqs = build_requests(np.random.default_rng(0), REQUESTS)
    greedy = [(p, n, 0.0) for p, n, _ in smallest_budgets(reqs, 8)]
    refill = smallest_budgets(reqs, TP_CUT_REQUESTS)
    serve_specs = {
        "f32_greedy": {"model": dict(serve_kw, compute_dtype="float32"), "tree": serve_tree,
                       "engine": dict(ENGINE), "requests": greedy},
        "bf16": {"model": serve_kw, "tree": serve_tree, "engine": dict(ENGINE),
                 "requests": refill},
        "int8_cache": {"model": serve_kw, "tree": serve_tree, "requests": refill,
                       "engine": dict(ENGINE, kv_quant=True)},
        "spec4": {"model": serve_kw, "tree": serve_tree, "requests": refill,
                  "engine": dict(ENGINE, speculative_k=SPECULATIVE_K, draft_table=table)},
    }
    moe = moe_rank_work()
    calls = [
        ("group_steps", [group_spec(f32_kw, f32_tree, {"data": 2}, parity_groups),
                         group_spec(bf16_kw, bf16_tree, {"data": 2}, dp_groups, warmup=1,
                                    timed=True),
                         group_spec(dict(f32_kw, **sp), f32_tree, tp_axes, parity_groups),
                         group_spec(dict(bf16_kw, **sp), bf16_tree, tp_axes, tp_groups,
                                    timed=True),
                         dict(group_spec(dict(f32_kw, **sp), f32_tree, tp_axes, parity_groups),
                              **ada)]),
        ("train_cli", ["--config", str(cfgs[1]), *cli_argv, "--mesh_devices", "2",
                       "--tensor_parallel", "2"]),
        ("serve", list(serve_specs.values())),
        ("group_steps", moe["groups"]),
        ("serve", list(moe["serve_specs"].values())),
    ]
    # in a fresh process under torch's deterministic algorithms (the embedding
    # gradient's atomics otherwise reorder its sums from run to run): the
    # one-rank card group with no mesh, then one rank of a data mesh over
    # NCCL, which issues the data-parallel collectives (the loss shares',
    # metrics' and gradient's all-reduces, ZeRO-1's all-gather; counted) and
    # gathers the weights and gradients to the writer, all at world 1
    exact = dict(group_spec(f32_kw, f32_tree, None, parity_groups), deterministic=True)
    ada_ref = dict(exact, **ada)
    return {"launch": prestart_ranks(2, calls), "exact": exact, "ada_ref": ada_ref,
            "f32_kw": f32_kw,
            "bf16_tree": bf16_tree, "dp_groups": dp_groups, "tp_groups": tp_groups,
            "cli_cfgs": cfgs, "cli_argv": cli_argv, "workdir": workdir,
            "serve_specs": serve_specs, "n_layer": bf16_kw["n_layer"], "moe": moe}


def phase_parallel_ranks(prep: dict) -> dict:
    """Release the two gloo ranks of ``prepare_parallel_ranks`` and run the
    NCCL rank beside them (most of its seconds go to starting up)."""
    exact = prep["exact"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nccl_launch = pool.submit(
            spawn_ranks, par_workers.group_steps, 1,
            [exact, dict(exact, axes={"data": 1}, time_collectives=True), prep["ada_ref"]],
            backend="nccl")
        ranks = release_ranks(prep["launch"])
        ref, nccl, ada_ref = nccl_launch.result()[0]
    moe = prep["moe"]
    steps = [[r[0][i] for r in ranks] for i in range(5)]
    moe_steps = [[r[3][i] for r in ranks] for i in range(len(moe["groups"]))]
    return dict({k: v for k, v in prep.items() if k not in ("launch", "exact", "ada_ref")},
                ref=ref, nccl=nccl, dp_parity=steps[0], dp_timed=steps[1],
                tp_parity=steps[2], tp_timed=steps[3], ada_ref=ada_ref,
                tp_adafactor=steps[4], cli=[r[1] for r in ranks],
                serve=[r[2] for r in ranks],
                moe=dict(moe, ep_parity=moe_steps[0], ep_timed=moe_steps[1],
                         dp_parity=moe_steps[2], serve=[r[4] for r in ranks]))


def phase_dp_train(card: str, peak_bw, peak_ops, par: dict) -> dict:
    """``[dp_train]``: bench.py's step config (10L8H d384, bf16 flash, G 16 x
    B 8 x T 512 global), ZeRO-1 on, 2 ranks of B 4 sharing the card over
    gloo and 1 rank over NCCL (run by ``phase_parallel_ranks``); the flash
    kernels at a rank's shape against their plain versions and timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    H, T = train_main.MAIN_TRAIN["n_head"], train_main.T
    D = train_main.MAIN_TRAIN["n_embd"] // H
    rank_timed = check_flash_case(gen, "dp_train_kernel", "rank_b4_h8_bf16", 4, H, H, T, T, D,
                                  torch.bfloat16, None, 0.1, 97, True, peak_bw, peak_ops)
    timed = par["dp_timed"]
    nonpad = int((torch.from_numpy(par["dp_groups"][0][1]) != 0).sum())
    row = log_timed_ranks("dp_train", "gloo_2_ranks_zero1_bf16", timed, nonpad,
                          par["n_layer"], len(par["dp_groups"]), card)
    parity = compare_group("dp_train", "gloo_2_ranks_zero1_f32", par["f32_kw"], par["ref"],
                           par["dp_parity"][0], TRAIN_PARITY_TOL)
    nccl = par["nccl"]
    if nccl["collectives"] < 4:  # 3 all-reduces and ZeRO-1's all-gather a group
        raise AssertionError(f"the NCCL group issued {nccl['collectives']} collectives")
    compare_group("dp_train", "nccl_1_rank_f32", par["f32_kw"], par["ref"], nccl,
                  TRAIN_PARITY_TOL, exact=True)
    # the mean wall time of a collective: gloo between two ranks on the card
    # (the bf16 groups') and NCCL at world 1 (the float32 group's)
    log("dp_train_collectives",
        gloo_2_ranks_ms=[r["collective_seconds"] * 1e3 / r["collectives"] for r in timed],
        nccl_1_rank_ms=nccl["collective_seconds"] * 1e3 / nccl["collectives"],
        nccl_collectives=nccl["collectives"], card=card)
    moments = [r["state_bytes"] for r in timed]
    full = 2 * 4 * sum(a.size for _, a in tree_leaves(par["bf16_tree"]))  # two f32 moments
    log("dp_train", moment_bytes_per_rank=moments, moment_bytes_one_rank=full,
        share_per_rank=[m / full for m in moments])
    if max(moments) > 0.6 * full:
        raise AssertionError(f"ZeRO-1 holds {moments} moment bytes a rank of {full}")
    return {"timed": rank_timed, "launches": timed[0]["launches"], "run": row,
            "parity": parity}


def phase_tp_train(card: str, peak_bw, peak_ops, par: dict) -> dict:
    """``[tp_train]``: the same config at tensor_parallel 2 with
    ``residual_sharding`` (sequence parallelism), 2 ranks of 4 heads (run by
    ``phase_parallel_ranks``); the flash kernels at a rank's shape checked
    and timed; the train CLI's tensor-parallel run resumed at world size 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(12)
    H, T, B = train_main.MAIN_TRAIN["n_head"], train_main.T, train_main.B
    D = train_main.MAIN_TRAIN["n_embd"] // H
    # rank 1's heads: its dropout keyed on heads 4..7 of 8, as the whole model's
    rank_timed = check_flash_case(gen, "tp_train_kernel", "rank_b8_h4_bf16", B, H // 2,
                                  H // 2, T, T, D, torch.bfloat16, None, 0.1, 97, True,
                                  peak_bw, peak_ops, heads=(H // 2, H))
    parity = compare_group("tp_train", "gloo_tp2_sp_f32", par["f32_kw"], par["ref"],
                           par["tp_parity"][0], TRAIN_PARITY_TOL)
    timed = par["tp_timed"]
    nonpad = int((torch.from_numpy(par["tp_groups"][0][1]) != 0).sum())
    row = log_timed_ranks("tp_train", "gloo_tp2_sp_bf16", timed, nonpad, par["n_layer"],
                          len(par["tp_groups"]), card, G=TP_TIMED_G)
    if [r["rc"] for r in par["cli"]] != [0, 0]:
        raise AssertionError(f"the TP train CLI exited {par['cli']}")
    run_dir = par["workdir"] / "runs" / "tp-run"
    last = run_dir / "checkpoints" / "last.npz"
    first = load_checkpoint(last)
    if train_cli(["--config", str(par["cli_cfgs"][2]), "--resume", str(last),
                  *par["cli_argv"]]) != 0:
        raise AssertionError("the world-1 resume of the TP checkpoint failed")
    curves = (run_dir / "scores" / "curves.csv").read_text().splitlines()
    final = json.loads((run_dir / "scores" / "metrics.json").read_text())
    losses = [float(first["train_loss"]), float(first["val_loss"]),
              final["last_train_loss"], final["last_val_loss"]]
    log("tp_train_cli", epochs=[1, 2], curves_rows=len(curves) - 1, losses=losses,
        step=int(first["step"]), status=final["status"], card=card)
    if len(curves) != 3 or not all(np.isfinite(losses)) or final["status"] != "completed":
        raise AssertionError(f"the TP CLI run and its resume: {curves} {final}")
    return {"timed": rank_timed, "launches": timed[0]["launches"], "run": row,
            "parity": parity}


def phase_tp_serve(card: str, peak_bw, peak_ops, par: dict) -> dict:
    """``[tp_serve]``: the serving benchmark's config (d384 8 heads, 64 slots,
    128 requests, max_seq_len 256) at tensor_parallel 2 (4 kv heads a rank;
    the drains, at ``TP_SERVE_LAYERS``, run by ``phase_parallel_ranks``) with
    a bf16 and an int8 cache and speculative K 4; float32 greedy tokens
    against the meshless engine's; the decode kernel at Hkv 4 and the chunk
    kernel at its local heads against their plain versions."""
    bf16, i8 = torch.bfloat16, torch.int8
    gen = torch.Generator(device="cuda").manual_seed(13)
    L, H, D = MAIN["n_layer"], MAIN["n_head"], MAIN["n_embd"] // MAIN["n_head"]
    slots, S = ENGINE["slots"], ENGINE["max_seq_len"]
    timed = {}
    for name, cdt in (("rank_hkv4_bf16", bf16), ("rank_hkv4_int8", i8)):
        q, k, v, mask, ks, vs, err, nan_err = check_decode_case(
            gen, "tp_serve_kernel", name, L, slots, S, H // 2, 1, D, cdt, bf16, "serve")
        timed[name] = time_decode_case(name, q, k, v, mask, ks, vs, H // 2, 1,
                                       da.decode_attention, peak_bw, peak_ops, err, nan_err,
                                       "tp_serve_kernel_time")
    S_spec = -(-(S + SPECULATIVE_K + 1) // 128) * 128
    case = check_chunk_case(gen, "tp_serve_kernel", "chunk_rank_hkv4_bf16", L, slots, S_spec,
                            H // 2, 1, SPECULATIVE_K + 1, D, bf16, bf16, False, False,
                            peak_bw, peak_ops)
    chunk_timed = time_chunk_case("tp_serve_kernel_time", "chunk_rank_hkv4_bf16", case)
    del case
    # the drains' caches: 2 layers
    for name, cdt, qdt in (("rank_hkv4_bf16_2l", bf16, bf16), ("rank_hkv4_int8_2l", i8, bf16),
                           ("rank_hkv4_f32_2l", torch.float32, torch.float32)):
        check_decode_case(gen, "tp_serve_kernel", name, TP_SERVE_LAYERS, slots, S, H // 2, 1,
                          D, cdt, qdt, "serve")
    check_chunk_case(gen, "tp_serve_kernel", "chunk_rank_hkv4_bf16_2l", TP_SERVE_LAYERS, slots,
                     S_spec, H // 2, 1, SPECULATIVE_K + 1, D, bf16, bf16, False, False,
                     peak_bw, peak_ops)

    specs, ranks = par["serve_specs"], par["serve"]
    ref = par_workers.serve(0, 1, dict(specs["f32_greedy"], mesh=False, device="cuda"))
    runs = {}
    for i, name in enumerate(specs):
        r0, r1 = ranks[0][i], ranks[1][i]
        tokens = sum(len(t) for t in r0["tokens"].values())
        if r0["tokens"] != r1["tokens"]:
            raise AssertionError(f"tp_serve {name}: the ranks emitted different tokens")
        budgets = [n for _, n, _ in specs[name]["requests"]]
        if [len(r0["tokens"][i]) for i in range(len(budgets))] != budgets:
            raise AssertionError(f"tp_serve {name}: a budget was not served")
        steps = r0["stats"]["decode_steps"]
        rounds = r0["stats"]["verify_rounds"]
        launches = [r["launches"] for r in (r0, r1)]
        layers = specs[name]["model"]["n_layer"]
        want = {"decode_attention": steps * layers, "decode_attention_chunk": rounds * layers}
        if any(lc != want for lc in launches):
            raise AssertionError(f"tp_serve {name}: launches {launches} != {want}")
        runs[name] = dict(seconds=max(r0["seconds"], r1["seconds"]), tokens=tokens,
                          tokens_per_s=tokens / max(r0["seconds"], r1["seconds"]),
                          launches_per_rank=launches, decode_steps=steps,
                          verify_rounds=rounds,
                          accept_rate=r0["stats"].get("speculative_accept_rate"))
        log("tp_serve", case=name, **runs[name], tensor_parallel=r0["stats"]["tensor_parallel"],
            card=card)
    greedy = specs["f32_greedy"]["requests"]
    same = all(ranks[0][0]["tokens"][i] == ref["tokens"][i] for i in range(len(greedy)))
    log("tp_serve_parity", case="f32_greedy", requests=len(greedy), equal_to_meshless=same)
    if not same:
        raise AssertionError("tp_serve: float32 greedy tokens differ from the meshless engine's")
    return {"timed": timed, "chunk_timed": chunk_timed, "runs": runs}


# --- phases 46-49: expert and pipeline parallelism -------------------------------
#
# The MoE recipe (configs/stage2.6_moe_4e_top2_d512_ep2.yaml's model, MOE_TRAIN)
# at expert parallel 2 and under a data mesh of 2, and served at tensor parallel
# 2, run in phase 42's launch of two ranks; the pipeline recipe
# (configs/stage2.6_large_12L8H_d512_pp4.yaml) in one launch of four ranks, all
# sharing the card over gloo. No scaling figure: the ranks share one card.

PP_CONFIG = Path(__file__).resolve().parent / "configs" / "stage2.6_large_12L8H_d512_pp4.yaml"
EP_TIMED_G = 2  # microbatches of the timed EP group: cut from the recipe's 16 (and 4) for time
MOE_DP_B = 7  # odd: one rank of the data mesh of 2 holds a padding row
PP_STAGES = 4
PP_CLI_LAYERS = 2  # the --pipeline_stages 2 CLI run's depth (cut from 12)


def moe_parallel_model(**over) -> tuple[dict, dict]:
    """(config kwargs, JAX-layout tree) of the MoE recipe's model (random
    weights from a seed) with ``over`` applied."""
    kw = dict(train_main.MOE_TRAIN, **over)
    cfg = CodonGPTConfig(**kw)
    torch.manual_seed(train_main.SEED)
    return kw, params_to_jax(CodonGPT(cfg), cfg)


def moe_rank_work() -> dict:
    """The MoE work of phase 42's two-rank launch: the float32 parity group
    (2 layers, capacity 0.5, B ``MOE_DP_B``) at expert parallel 2 and at
    data parallel 2, one timed bf16 group at expert parallel 2 at full
    width, and the tensor-parallel MoE drains."""
    f32_kw, f32_tree = moe_parallel_model(compute_dtype="float32", dropout=0.0, n_layer=2,
                                          moe_capacity_factor=MOE_PARITY_CAPACITY)
    parity = [tuple(train_main.make_batch(31, "cpu", groups=2, batch=MOE_DP_B)[k].numpy()
                    for k in ("x", "y"))]
    for _, y in parity:
        y[0, 1, 300:] = 0
        y[1, 4, :] = 0
    bf16_kw, bf16_tree = moe_parallel_model()
    timed = [tuple(train_main.make_batch(32, "cpu", groups=EP_TIMED_G)[k].numpy()
                   for k in ("x", "y"))]
    ep = {"data": 1, "model": 2}
    groups = [group_spec(f32_kw, f32_tree, ep, parity),
              group_spec(bf16_kw, bf16_tree, ep, timed, warmup=1, timed=True),
              group_spec(f32_kw, f32_tree, {"data": 2}, parity)]
    # serving: the MoE model at tensor parallel 2 (experts split 2 a rank), at
    # 2 layers (a depth cut); float32 greedy on the 4 smallest budgets, bf16
    # and K 4 on the 66 smallest (slots refill): cuts for time
    reqs = build_requests(np.random.default_rng(0), REQUESTS)
    greedy = [(p, n, 0.0) for p, n, _ in smallest_budgets(reqs, TP_GREEDY_REQUESTS)]
    greedy_kw, greedy_tree = moe_parallel_model(compute_dtype="float32", n_layer=TP_SERVE_LAYERS)
    serve_kw, serve_tree = moe_parallel_model(n_layer=TP_SERVE_LAYERS)
    cfg = CodonGPTConfig(**serve_kw)
    table = fit_draft_table(params_from_jax(serve_tree, cfg, "cuda"), cfg)
    refill = smallest_budgets(reqs, TP_CUT_REQUESTS)
    serve_specs = {
        "f32_greedy": {"model": greedy_kw, "tree": greedy_tree, "engine": dict(ENGINE),
                       "requests": greedy},
        "bf16": {"model": serve_kw, "tree": serve_tree, "engine": dict(ENGINE),
                 "requests": refill},
        "spec4": {"model": serve_kw, "tree": serve_tree, "requests": refill,
                  "engine": dict(ENGINE, speculative_k=SPECULATIVE_K, draft_table=table)},
    }
    return {"groups": groups, "serve_specs": serve_specs, "f32_kw": f32_kw,
            "f32_tree": f32_tree, "parity_groups": parity, "bf16_kw": bf16_kw,
            "bf16_tree": bf16_tree, "timed_groups": timed}


def one_rank_group(kw, tree, groups) -> dict:
    """The float32 group on one rank of the card with no mesh (the parity
    reference), in this process."""
    return par_workers.group_steps(0, 1, dict(group_spec(kw, tree, None, groups),
                                              device="cuda"))


def phase_ep_train(card: str, peak_bw, peak_ops, par: dict) -> dict:
    """``[ep_train]``: the MoE recipe at expert parallel 2 (two ranks on
    ``{"data": 1, "model": 2}``, each holding 2 of the 4 experts and 4 of the
    8 heads): the flash kernels at a rank's 4 heads of 64 checked and timed;
    the float32 group (2 layers, capacity 0.5) against the one-rank group;
    one timed bf16 group at full width (``EP_TIMED_G`` microbatches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    moe = par["moe"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    H, T, B = train_main.MOE_TRAIN["n_head"], train_main.T, train_main.B
    D = train_main.MOE_TRAIN["n_embd"] // H
    rank_timed = check_flash_case(gen, "ep_train_kernel", "rank_b8_h4_d64_bf16", B, H // 2,
                                  H // 2, T, T, D, torch.bfloat16, None, 0.1, 97, True,
                                  peak_bw, peak_ops, heads=(H // 2, H))
    # the float32 parity groups' shapes: B 7 x 4 heads (EP), B 4 x 8 heads (DP)
    for name, b, h in (("rank_b7_h4_d64_f32", MOE_DP_B, H // 2),
                       ("rank_b4_h8_d64_f32", -(-MOE_DP_B // 2), H)):
        check_flash_case(gen, "ep_train_kernel", name, b, h, h, T, T, D, torch.float32, None,
                         0.0, 97, False, peak_bw, peak_ops)
    ref = one_rank_group(moe["f32_kw"], moe["f32_tree"], moe["parity_groups"])
    moe["ref"] = ref
    parity = compare_group("ep_train", "gloo_ep2_f32_capacity_0.5", moe["f32_kw"], ref,
                           moe["ep_parity"][0], TRAIN_PARITY_TOL)
    timed = moe["ep_timed"]
    x, y = moe["timed_groups"][0]
    rows = []
    for r, res in enumerate(timed):
        launches = {k: v for k, v in res["launches"].items()}
        rows.append(dict(rank=r, seconds=res["seconds"], collectives=res["collectives"],
                         collective_share=res["collective_seconds"] / res["seconds"],
                         collective_bytes=res["collective_bytes"], flash_launches=launches,
                         expert_bytes=res["expert_bytes"], moment_bytes=res["state_bytes"],
                         dropped_choices=res["dropped_choices"]))
        want = EP_TIMED_G * train_main.MOE_TRAIN["n_layer"]
        if any(v != want for v in launches.values()):
            raise AssertionError(f"ep_train: rank {r} launched {launches}, not {want} each")
    full_experts = 4 * sum(a.size for n, a in tree_leaves(moe["bf16_tree"])
                           if n.startswith("blocks/mlp/"))  # float32 masters
    seconds = max(res["seconds"] for res in timed)
    out = dict(case="gloo_ep2_bf16", groups=1, microbatches=EP_TIMED_G, ranks=rows,
               ms_per_group=seconds * 1e3, nonpad_tokens_per_s=int((y != 0).sum()) / seconds,
               expert_bytes_one_rank=full_experts,
               expert_share_per_rank=[r["expert_bytes"] / full_experts for r in rows],
               card=card)
    log("ep_train", **out)
    if any(abs(share - 0.5) > 1e-9 for share in out["expert_share_per_rank"]):
        raise AssertionError(f"ep_train: a rank holds {out['expert_share_per_rank']} "
                             "of the experts, not half")
    return {"timed": rank_timed, "launches": timed[0]["launches"], "run": out,
            "parity": parity}


def phase_moe_dp(card: str, par: dict) -> dict:
    """``[moe_dp]``: the same float32 MoE group (capacity 0.5, B 7) on a data
    mesh of 2 (rank 1's fourth row is padding), routed over the global
    microbatch, against the one-rank group; the dropped choices counted."""
    moe = par["moe"]
    ranks = moe["dp_parity"]
    parity = compare_group("moe_dp", "gloo_dp2_f32_capacity_0.5_b7", moe["f32_kw"], moe["ref"],
                           ranks[0], TRAIN_PARITY_TOL)
    dropped = sum(r["dropped_choices"] for r in ranks)
    choices = 2 * 2 * moe["f32_kw"]["n_layer"] * MOE_DP_B * train_main.T  # G x k x L x tokens
    log("moe_dp", dropped_choices=dropped, dropped_choices_one_rank=moe["ref"]["dropped_choices"],
        choices=choices, dropped_per_rank=[r["dropped_choices"] for r in ranks], card=card)
    if not dropped:  # capacity 0.5 must bind (the counts may part on a near tie)
        raise AssertionError("moe_dp: no choice dropped at capacity 0.5")
    return {"parity": parity, "dropped": dropped}


def phase_tp_moe_serve(card: str, peak_bw, peak_ops, par: dict) -> dict:
    """``[tp_moe_serve]``: the MoE recipe's model served at tensor parallel 2
    (4 of 8 heads and 2 of 4 experts a rank), at ``TP_SERVE_LAYERS``: float32
    greedy tokens against the meshless engine's, a bf16 drain and a
    speculative K 4 drain of 66 requests into 64 slots (so slots refill); the decode
    and chunk kernels at a rank's 4 kv heads of 64 against their plain
    versions, bf16 timed."""
    bf16 = torch.bfloat16
    moe = par["moe"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    kw = moe["bf16_kw"]
    L, H = kw["n_layer"], kw["n_head"]
    D = kw["n_embd"] // H
    slots, S = ENGINE["slots"], ENGINE["max_seq_len"]
    timed = {}
    q, k, v, mask, ks, vs, err, nan_err = check_decode_case(
        gen, "tp_moe_serve_kernel", "rank_hkv4_d64_bf16", L, slots, S, H // 2, 1, D, bf16,
        bf16, "serve")
    timed["decode"] = time_decode_case("rank_hkv4_d64_bf16", q, k, v, mask, ks, vs, H // 2, 1,
                                       da.decode_attention, peak_bw, peak_ops, err, nan_err,
                                       "tp_moe_serve_kernel_time")
    del q, k, v, mask, ks, vs
    # the float32 greedy drain's model: 2 layers
    check_decode_case(gen, "tp_moe_serve_kernel", "rank_hkv4_d64_f32", TP_SERVE_LAYERS, slots,
                      S, H // 2, 1, D, torch.float32, torch.float32, "serve")
    S_spec = -(-(S + SPECULATIVE_K + 1) // 128) * 128
    case = check_chunk_case(gen, "tp_moe_serve_kernel", "chunk_rank_hkv4_d64_bf16", L, slots,
                            S_spec, H // 2, 1, SPECULATIVE_K + 1, D, bf16, bf16, False, False,
                            peak_bw, peak_ops)
    timed["chunk"] = time_chunk_case("tp_moe_serve_kernel_time", "chunk_rank_hkv4_d64_bf16",
                                     case)
    del case
    # the drains' caches: 2 layers
    check_decode_case(gen, "tp_moe_serve_kernel", "rank_hkv4_d64_bf16_2l", TP_SERVE_LAYERS,
                      slots, S, H // 2, 1, D, bf16, bf16, "serve")
    check_chunk_case(gen, "tp_moe_serve_kernel", "chunk_rank_hkv4_d64_bf16_2l", TP_SERVE_LAYERS,
                     slots, S_spec, H // 2, 1, SPECULATIVE_K + 1, D, bf16, bf16, False, False,
                     peak_bw, peak_ops)
    specs, ranks = moe["serve_specs"], moe["serve"]
    ref = par_workers.serve(0, 1, dict(specs["f32_greedy"], mesh=False, device="cuda"))
    runs = {}
    for i, name in enumerate(specs):
        r0, r1 = ranks[0][i], ranks[1][i]
        if r0["tokens"] != r1["tokens"]:
            raise AssertionError(f"tp_moe_serve {name}: the ranks emitted different tokens")
        budgets = [n for _, n, _ in specs[name]["requests"]]
        if [len(r0["tokens"][j]) for j in range(len(budgets))] != budgets:
            raise AssertionError(f"tp_moe_serve {name}: a budget was not served")
        steps, rounds = r0["stats"]["decode_steps"], r0["stats"]["verify_rounds"]
        launches = [r["launches"] for r in (r0, r1)]
        layers = specs[name]["model"]["n_layer"]
        want = {"decode_attention": steps * layers, "decode_attention_chunk": rounds * layers}
        if any(lc != want for lc in launches):
            raise AssertionError(f"tp_moe_serve {name}: launches {launches} != {want}")
        tokens = sum(len(t) for t in r0["tokens"].values())
        seconds = max(r0["seconds"], r1["seconds"])
        runs[name] = dict(seconds=seconds, tokens=tokens, tokens_per_s=tokens / seconds,
                          launches_per_rank=launches, decode_steps=steps, verify_rounds=rounds,
                          accept_rate=r0["stats"].get("speculative_accept_rate"))
        log("tp_moe_serve", case=name, **runs[name], card=card)
    n = len(specs["f32_greedy"]["requests"])
    same = all(ranks[0][0]["tokens"][j] == ref["tokens"][j] for j in range(n))
    log("tp_moe_serve_parity", case="f32_greedy", requests=n, equal_to_meshless=same)
    if not same:
        raise AssertionError("tp_moe_serve: float32 greedy tokens differ from the meshless "
                             "engine's")
    return {"timed": timed, "runs": runs}


def prepare_pp_ranks(card: str, workdir: Path) -> dict:
    """The ranks' work of phase 49, prestarted (``prestart_ranks``) as one
    launch of four ranks sharing the card over gloo: the float32 pipeline
    group (4 layers, one a stage) and one timed bf16 group at full width on
    ``{"data": 1, "pipe": 4}``, and the train CLI at ``--mesh_devices 4
    --pipeline_stages 2`` (2 layers, one microbatch a group, 1 epoch);
    ``phase_pp_ranks`` runs it."""
    import yaml

    recipe = yaml.safe_load(PP_CONFIG.read_text())
    cfg = CodonGPTConfig.from_run_config(dict(recipe, vocab_size=68))  # as the trainer builds it
    kw = dataclasses.asdict(cfg)
    torch.manual_seed(train_main.SEED)
    tree = params_to_jax(CodonGPT(cfg), cfg)
    f32_kw = dict(kw, compute_dtype="float32", dropout=0.0, n_layer=PP_STAGES)
    f32_tree = params_to_jax(CodonGPT(CodonGPTConfig(**f32_kw)), CodonGPTConfig(**f32_kw))
    # every row non-pad: the whole-group CE equals the one-rank step's mean of
    # microbatch means, so the one-rank group is the reference
    parity = [tuple(train_main.make_batch(41, "cpu", groups=2)[k].numpy() for k in ("x", "y"))]
    timed = [tuple(train_main.make_batch(42, "cpu", groups=recipe["grad_accum_steps"])[k]
                   .numpy() for k in ("x", "y"))]
    axes = {"data": 1, "pipe": PP_STAGES}
    packed_corpus(workdir, 64, 16)
    # one microbatch a group: the objectives coincide, so the world-1 resume
    # (no pipeline) may continue the run
    cfgs = {e: recipe_yaml(PP_CONFIG, "pp_config", workdir, f"pp_e{e}", run_id="pp-run",
                           n_layer=PP_CLI_LAYERS, grad_accum_steps=1, epochs=e, warmup_steps=1,
                           scheduler_total_steps=16, pipeline_stages=2)
            for e in (1, 2)}
    cli_argv = ["--run_root", str(workdir / "runs"), "--device", "cuda:0"]
    calls = [
        ("group_steps", [group_spec(f32_kw, f32_tree, axes, parity),
                         group_spec(kw, tree, axes, timed, warmup=1, timed=True)]),
        ("train_cli", ["--config", str(cfgs[1]), *cli_argv, "--mesh_devices", "4"]),
    ]
    return {"launch": prestart_ranks(PP_STAGES, calls), "f32_kw": f32_kw,
            "f32_tree": f32_tree, "parity_groups": parity, "timed_groups": timed,
            "cli_cfgs": cfgs, "cli_argv": cli_argv, "workdir": workdir, "kw": kw}


def phase_pp_ranks(prep: dict) -> dict:
    """Release the four ranks of ``prepare_pp_ranks``; their results."""
    ranks = release_ranks(prep["launch"])
    return dict({k: v for k, v in prep.items() if k != "launch"},
                parity=[r[0][0] for r in ranks], timed=[r[0][1] for r in ranks],
                cli=[r[1] for r in ranks])


def phase_pp_train(card: str, peak_bw, peak_ops, pp: dict) -> dict:
    """``[pp_train]``: the pipeline recipe at full width on four ranks (3 of
    the 12 layers a stage, G 16 x B 8 x T 512, bf16, dropout 0.1): the
    float32 group against the one-rank group; one timed bf16 group (ms,
    tokens/s, the share in sends and receives, the schedule's bubble); each
    stage's flash launches; the CLI run resumed at world size 1 from its
    merged checkpoint. The flash kernels at a stage's shape (B 8 x H 8,
    heads of 64) are phase 7's d512 case; the float32 group's are checked
    here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = pp["kw"]
    gen = torch.Generator(device="cuda").manual_seed(16)
    H, T, B = kw["n_head"], kw["block_size"], train_main.B
    log("pp_kernels", stage_shape=dict(B=B, H=H, T=T, D=kw["n_embd"] // H, dtype="bf16",
                                       dropout=kw["dropout"]),
        checked_by="phase 7's d512_main_bf16 case (the same shape)")
    check_flash_case(gen, "pp_train_kernel", "stage_b8_h8_d64_f32", B, H, H, T, T,
                     kw["n_embd"] // H, torch.float32, None, 0.0, 97, False, peak_bw, peak_ops)
    ref = one_rank_group(pp["f32_kw"], pp["f32_tree"], pp["parity_groups"])
    parity = compare_group("pp_train", "gloo_pp4_f32", pp["f32_kw"], ref, pp["parity"][0],
                           TRAIN_PARITY_TOL)
    G = len(pp["timed_groups"][0][0])
    per_stage = kw["n_layer"] // PP_STAGES
    rows = []
    for r, res in enumerate(pp["timed"]):
        launches = dict(res["launches"])
        if any(v != G * per_stage for v in launches.values()):
            raise AssertionError(f"pp_train: stage {r} launched {launches}, not "
                                 f"{G * per_stage} each")
        p2p = res["collective_seconds_by_op"].get("collective-permute", 0.0)
        rows.append(dict(stage=r, seconds=res["seconds"], flash_launches=launches,
                         p2p_seconds=p2p, p2p_share=p2p / res["seconds"],
                         p2p_bytes=res["collective_bytes"].get("collective-permute", 0),
                         collective_share=res["collective_seconds"] / res["seconds"],
                         moment_bytes=res["state_bytes"]))
    seconds = max(res["seconds"] for res in pp["timed"])
    y = pp["timed_groups"][0][1]
    out = dict(case="gloo_pp4_bf16", stages=PP_STAGES, microbatches=G,
               bubble=(PP_STAGES - 1) / (G + PP_STAGES - 1), ranks=rows,
               ms_per_group=seconds * 1e3, nonpad_tokens_per_s=int((y != 0).sum()) / seconds,
               loss=pp["timed"][0]["metrics"][0]["first_loss"], card=card)
    log("pp_train", **out)
    if not np.isfinite(out["loss"]):
        raise AssertionError("pp_train: the bf16 group's loss is not finite")
    if any(r["rc"] != 0 for r in pp["cli"]):
        raise AssertionError(f"the pipeline train CLI exited {pp['cli']}")
    run_dir = pp["workdir"] / "runs" / "pp-run"
    last = run_dir / "checkpoints" / "last.npz"
    first = load_checkpoint(last)
    if first["train_objective"] != "group_ce" or first["model"]["blocks"]["ln1"][
            "scale"].shape[0] != PP_CLI_LAYERS:
        raise AssertionError("the pipeline checkpoint is not the merged group-CE layout")
    if train_cli(["--config", str(pp["cli_cfgs"][2]), "--resume", str(last), *pp["cli_argv"],
                  "--pipeline_stages", "1"]) != 0:
        raise AssertionError("the world-1 resume of the pipeline checkpoint failed")
    curves = (run_dir / "scores" / "curves.csv").read_text().splitlines()
    final = json.loads((run_dir / "scores" / "metrics.json").read_text())
    losses = [float(first["train_loss"]), float(first["val_loss"]),
              final["last_train_loss"], final["last_val_loss"]]
    log("pp_train_cli", epochs=[1, 2], curves_rows=len(curves) - 1, losses=losses,
        step=int(first["step"]), status=final["status"], card=card)
    if len(curves) != 3 or not all(np.isfinite(losses)) or final["status"] != "completed":
        raise AssertionError(f"the pipeline CLI run and its resume: {curves} {final}")
    return {"launches": pp["timed"][0]["launches"], "run": out, "parity": parity}


# --- phases 29a-29c: genome ingestion (the native tool, GenBank, the hybrid model) --

GBFF_SPACER_NT = (60, 200)  # intergenic spacers between genes: the 30/60 nt flanks are real
GBFF_N_SPACER_EVERY = 9  # every 9th spacer holds one N
GBFF_N_GENES = 3  # genes given one N in a middle codon (an ambiguous codon)
GBFF_OVERLAP_PAIRS = 2  # plus-strand neighbours sharing the upstream gene's last base
GBFF_SEED = 16
ECOLI_BP, ECOLI_CDS = 4_641_652, 4_300  # E. coli K-12 MG1655 (NCBI RefSeq NC_000913.3)
HYBRID_G, HYBRID_EPOCHS = 2, 4  # 23 groups an epoch over the 367 train windows
HYBRID_VOCAB = 74
GBFF_STOPS = ("TAA", "TAG", "TGA")


def gbff_record_text(locus: str, accession: str, organism: str, seq: str,
                     features: list[tuple[str, int]]) -> str:
    """One GenBank flat-file record: CDS features (``start..end`` or
    ``complement(...)``, 1-based) with a locus tag and a product wrapped over
    two lines, and the sequence as a lower-case ORIGIN block."""
    out = [f"LOCUS       {locus}  {len(seq)} bp    DNA     circular BCT 01-JAN-2026",
           f"DEFINITION  {organism} chromosome, synthetic.", f"ACCESSION   {accession}",
           f"SOURCE      {organism}", f"  ORGANISM  {organism}",
           "FEATURES             Location/Qualifiers", f"     source          1..{len(seq)}"]
    for loc, i in features:
        out += [f"     CDS             {loc}", f'                     /locus_tag="{locus}_{i:05d}"',
                f'                     /product="synthetic protein {i} of',
                f'                     {locus}"']
    out.append("ORIGIN")
    low = seq.lower()
    for off in range(0, len(low), 60):
        row = low[off:off + 60]
        out.append(f"{off + 1:9d} " + " ".join(row[j:j + 10] for j in range(0, len(row), 10)))
    return "\n".join(out) + "\n//\n"


def write_demo_gbffs(records: list[dict], workdir: Path) -> dict:
    """One GBFF a genome of the demo corpus (``GCF_<n>.1_smoke_genomic.gbff``,
    its record ``NZ_SMOKE<n>.1``): the genome's genes in corpus order, every
    other one on the minus strand (reverse-complemented), 60-200 nt random
    spacers between them (every 9th with an N), 3 genes with an N in a
    middle codon, and in the first two genomes one plus-strand pair whose
    downstream gene starts on the upstream gene's last base (its stop's A),
    as ``TAATG`` overlaps do. Returns the paths and the genes as written."""
    rng = np.random.default_rng(GBFF_SEED)
    by_genome: dict[str, list[dict]] = {}
    for r in records:
        by_genome.setdefault(r["genome"], []).append(r)
    genomes = sorted(by_genome)
    n_genes = {(int(g), int(i)) for g, i in zip(
        rng.choice(len(genomes), GBFF_N_GENES, replace=False),
        rng.integers(0, min(len(v) for v in by_genome.values()), GBFF_N_GENES))}
    paths, written, minus_count, spacers_n, overlaps = [], [], 0, 0, []
    for n, genome in enumerate(genomes):
        genes = [r["sequence"] for r in by_genome[genome]]
        pair = None
        if n < GBFF_OVERLAP_PAIRS:  # an even (plus) gene ending in A, its successor forced plus
            pair = next(i for i in range(0, len(genes) - 1, 2) if genes[i].endswith("A"))
        parts, feats, pos, spacer_i = [], [], 0, 0
        for i, gene in enumerate(genes):
            if (n, i) in n_genes:
                c = 3 * (len(gene) // 6)
                gene = gene[:c + 1] + "N" + gene[c + 2:]
            if pair is not None and i == pair + 1:
                pos -= 1  # the downstream gene starts on the upstream stop's A
                parts[-1] = parts[-1][:-1]
                overlaps.append((genome, pair, pair + 1))
            else:
                spacer = list(rng.choice(list("ACGT"), int(rng.integers(*GBFF_SPACER_NT) + 1)))
                if spacer_i % GBFF_N_SPACER_EVERY == 0:
                    spacer[int(rng.integers(0, len(spacer)))] = "N"
                    spacers_n += 1
                spacer_i += 1
                parts.append("".join(spacer))
                pos += len(spacer)
            minus = i % 2 == 1 and not (pair is not None and i == pair + 1)
            minus_count += minus
            text = dna_reverse_complement(gene) if minus else gene
            loc = f"{pos + 1}..{pos + len(gene)}"
            feats.append((f"complement({loc})" if minus else loc, i))
            parts.append(text)
            pos += len(gene)
            written.append(gene)
        parts.append("".join(rng.choice(list("ACGT"), 150)))
        path = workdir / f"GCF_{n + 1:09d}.1_smoke_genomic.gbff"
        genus = by_genome[genome][0]["genus"]
        path.write_text(gbff_record_text(f"SMOKE{n + 1:02d}", f"NZ_SMOKE{n + 1:02d}.1",
                                         f"{genus.capitalize()} smoke{n + 1}", "".join(parts),
                                         feats))
        paths.append(path)
    return dict(paths=paths, genes=written, minus=minus_count, spacers_with_n=spacers_n,
                genes_with_n=len(n_genes), overlaps=overlaps)


def write_ecoli_scale_gbff(path: Path) -> dict:
    """One synthetic record at E. coli K-12 MG1655's scale: ``ECOLI_BP``
    bases, ``ECOLI_CDS`` CDS of 100-532 sense codons (mean ~316, as E.
    coli's ~950 nt) on either strand, the rest spacers."""
    rng = np.random.default_rng(GBFF_SEED + 1)
    sense = np.array([a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
                      if a + b + c not in GBFF_STOPS])
    lengths = rng.integers(100, 533, ECOLI_CDS)
    genes = ["ATG" + "".join(sense[rng.integers(0, len(sense), n)])
             + GBFF_STOPS[int(rng.integers(0, 3))] for n in lengths]
    coding = sum(len(g) for g in genes)
    spacers = rng.multinomial(ECOLI_BP - coding, np.full(ECOLI_CDS + 1, 1 / (ECOLI_CDS + 1)))
    bases = np.array(list("ACGT"))
    parts, feats, pos = [], [], 0
    for i, gene in enumerate(genes):
        parts.append("".join(bases[rng.integers(0, 4, int(spacers[i]))]))
        pos += int(spacers[i])
        minus = bool(rng.integers(0, 2))
        parts.append(dna_reverse_complement(gene) if minus else gene)
        loc = f"{pos + 1}..{pos + len(gene)}"
        feats.append((f"complement({loc})" if minus else loc, i))
        pos += len(gene)
    parts.append("".join(bases[rng.integers(0, 4, int(spacers[-1]))]))
    seq = "".join(parts)
    path.write_text(gbff_record_text("ECOLISCALE", "NZ_ECOLISCALE.1", "Escherichia smoke",
                                     seq, feats))
    return dict(bp=len(seq), cds=len(genes), coding_bp=coding, bytes=path.stat().st_size)


def phase_native(records: list[dict], card: str) -> dict:
    """The native host library built from ``native/genomics_native.cpp`` (g++,
    seconds logged), then each entry point on the demo corpus's 800 CDS and
    their 800 proteins against its plain version: cluster labels (the
    audit's k 4 at the Jaccard of identity 0.3, and the defaults k 5 at
    0.5), codon ids, reverse complements and digests all identical."""
    from genomics_lm_torch import native
    from genomics_lm_torch.data.leakage import translate_cds

    fresh = not native.library_path().exists()
    t0 = time.perf_counter()
    native.sha256_hex(b"")  # builds and loads; raises with g++'s output on a failure
    build_s = time.perf_counter() - t0
    cds = [r["sequence"] for r in records]
    proteins = [translate_cds(s) for s in cds]
    checks, seconds = {}, {}
    for name, kw in (("minhash_audit", dict(k=4, n_hashes=64, min_jaccard=0.3 / 1.7)),
                     ("minhash_default", dict(k=5, n_hashes=64, min_jaccard=0.5))):
        t0 = time.perf_counter()
        got = native.minhash_cluster(proteins, **kw)
        t1 = time.perf_counter()
        want = native.minhash_cluster_reference(proteins, **kw)
        seconds[name] = dict(library=t1 - t0, plain=time.perf_counter() - t1)
        checks[name] = dict(equal=bool(np.array_equal(got, want)),
                            clusters=len(set(got.tolist())))
    pairs = {
        "tokenize_codons": (lambda s: native.tokenize_codons(s).tolist(),
                            lambda s: native.tokenize_codons_reference(s).tolist(), cds),
        "reverse_complement": (native.reverse_complement, native.reverse_complement_reference,
                               cds),
        "sha256_hex": (lambda s: native.sha256_hex(s.encode()),
                       lambda s: native.sha256_hex_reference(s.encode()), cds + proteins),
    }
    for name, (fn, ref, inputs) in pairs.items():
        t0 = time.perf_counter()
        got = [fn(s) for s in inputs]
        t1 = time.perf_counter()
        want = [ref(s) for s in inputs]
        seconds[name] = dict(library=t1 - t0, plain=time.perf_counter() - t1)
        checks[name] = dict(equal=got == want, inputs=len(inputs))
    log("native", library=native.library_path().name, built_now=fresh, build_s=build_s,
        cds=len(cds), proteins=len(proteins), checks=checks, seconds=seconds, card=card)
    bad = [name for name, c in checks.items() if not c["equal"]]
    if bad:
        raise AssertionError(f"native entry points differ from their plain versions: {bad}")
    return {"build_s": build_s, "checks": checks}


def phase_genbank(records: list[dict], workdir: Path, card: str) -> dict:
    """GenBank ingestion on the demo corpus written as 12 GBFF files (one a
    genome, ``write_demo_gbffs``): ``extract_cds_records`` returns the 800
    genes as written, as a multiset in coding orientation; ``pipeline_prepare
    --gbff`` at block 512 (``multi``, genome-disjoint, the native homology
    audit on) twice, equal ids and a valid manifest; then parse, extract and
    the native audit of one GBFF at E. coli K-12 MG1655's scale, timed."""
    from collections import Counter

    from genomics_lm_torch.data.genbank import extract_cds_records
    from genomics_lm_torch.data.leakage import audit_source_records
    from genomics_lm_torch.data.manifest import load_dataset_manifest
    from genomics_lm_torch.data.pipeline import assign_group_splits
    from genomics_lm_torch.data.pipeline_prepare import main as prepare_cli

    gbff_dir = workdir / "gbff"
    gbff_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    written = write_demo_gbffs(records, gbff_dir)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = [row for p in written["paths"] for row in extract_cds_records(p)]
    extract_s = time.perf_counter() - t0
    genes_equal = Counter(r["sequence"] for r in rows) == Counter(written["genes"])
    ids, seconds, manifest = [], [], None
    for attempt in range(2):
        out = workdir / f"gbff_dataset_{attempt}"
        t0 = time.perf_counter()
        _run_cli(prepare_cli, ["--gbff", *map(str, written["paths"]), "--out_dir", str(out),
                               "--block_size", "512", "--pack_mode", "multi",
                               "--group_by", "genome", "--audit_engine", "native"])
        seconds.append(time.perf_counter() - t0)
        manifest = load_dataset_manifest(out / "manifest.json", verify_artifacts=True)
        ids.append(manifest["dataset"]["id"])
    audit = json.loads((workdir / "gbff_dataset_0" / "leakage_audit.json").read_text())
    windows = {}
    for split in ("train", "val", "test"):
        with np.load(workdir / "gbff_dataset_0" / f"{split}_bs512.npz") as z:
            windows[split] = int(z["X"].shape[0])

    ecoli_path = workdir / "ecoli_scale.gbff"
    t0 = time.perf_counter()
    ecoli = write_ecoli_scale_gbff(ecoli_path)
    ecoli_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ecoli_rows = extract_cds_records(ecoli_path)
    parse_extract_s = time.perf_counter() - t0
    split_rows, _ = assign_group_splits(
        [{"sequence": r["sequence"], "source_id": r["source_id"]} for r in ecoli_rows],
        group_by="sequence", seed=0)
    t0 = time.perf_counter()
    ecoli_audit = audit_source_records(split_rows, workdir / "ecoli_audit.json",
                                       engine="native")
    audit_s = time.perf_counter() - t0
    row = dict(files=len(written["paths"]), cds=len(rows), genes_as_written=genes_equal,
               minus_strand=written["minus"], spacers_with_n=written["spacers_with_n"],
               genes_with_n=written["genes_with_n"], overlaps=written["overlaps"],
               write_s=write_s, extract_s=extract_s, dataset_ids=ids,
               ids_equal=ids[0] == ids[1], manifest_valid=True, prepare_s=seconds,
               records=manifest["split_policy"]["record_counts"], windows=windows,
               audit_status=audit["status"], audit_engine=audit["engine"],
               protein_clusters=audit["protein_homology"]["cluster_count"],
               cross_split_clusters=audit["protein_homology"]["cross_split_cluster_count"],
               scientific_valid=manifest["dataset"]["scientific_valid"],
               ecoli_scale=dict(ecoli, write_s=ecoli_write_s, parse_extract_s=parse_extract_s,
                                native_audit_s=audit_s, cds_extracted=len(ecoli_rows),
                                clusters=ecoli_audit["protein_homology"]["cluster_count"],
                                status=ecoli_audit["status"]),
               card=card)
    log("genbank", **row)
    if not genes_equal or len(rows) != len(records):
        raise AssertionError(f"extract_cds_records gave {len(rows)} CDS, not the "
                             f"{len(records)} genes as written")
    if ids[0] != ids[1] or min(windows.values()) == 0 or audit["engine"] != "native":
        raise AssertionError(f"--gbff datasets: ids {ids}, windows {windows}")
    if len(ecoli_rows) != ECOLI_CDS or ecoli["bp"] != ECOLI_BP:
        raise AssertionError(f"E. coli-scale record: {ecoli}, {len(ecoli_rows)} CDS")
    return {"paths": written["paths"], "row": row}


def phase_hybrid_train(gbff: dict, workdir: Path, card: str, peak_bw, peak_ops) -> dict:
    """``pipeline_prepare_hybrid`` on phase 29b's 12 GBFF files (block 512,
    flanks 30 and 60 nt), its integrity gate passed and the combined
    ``itos.txt`` of 74 lines; then the train CLI at the main path's width
    (``run_yaml``: 10L8H d384, bf16 flash, dropout 0.1) on the combined
    hybrid splits, G 2 for ``HYBRID_EPOCHS`` epochs: every loss finite, the
    last validation loss under ln 74, the model's vocabulary 74, and each
    flash kernel's launches (reset just before, read just after) 10 per
    microbatch, the forward's also 10 per validation microbatch. Then the
    three flash kernels on one real bf16 microbatch of the hybrid train split
    with its segment ids (``<UNK>``, id 3, also separates the packed lines)
    against their plain versions, timed."""
    import yaml

    from genomics_lm_torch.data.pipeline_prepare_hybrid import main as prepare_hybrid_cli

    cfg_path = workdir / "hybrid_prepare.yaml"
    cfg_path.write_text(yaml.safe_dump({
        "block_size": train_main.T,
        "datasets": [{"name": p.name.split("_genomic")[0], "gbff": str(p), "min_len": 90}
                     for p in gbff["paths"]]}))
    run_dir = workdir / "hybrid_prepare_run"
    t0 = time.perf_counter()
    printed = _run_cli(prepare_hybrid_cli, [
        "--config", str(cfg_path), "--run-id", "smoke-hybrid", "--run-dir", str(run_dir),
        "--out-root", str(workdir / "processed"), "--upstream", "30", "--downstream", "60",
        "--pack_mode", "multi"])
    prepare_s = time.perf_counter() - t0
    result = json.loads((run_dir / "pipeline_prepare.json").read_text())
    integrity = json.loads((run_dir / "integrity.json").read_text())
    itos = Path(result["itos"]).read_text().splitlines()
    train_npz, val_npz = Path(result["train_npz"]), Path(result["val_npz"])
    with np.load(train_npz) as z:
        X = z["X"]
    with np.load(val_npz) as z:
        n_val = int(z["X"].shape[0])
    B, L = train_main.B, train_main.MAIN_TRAIN["n_layer"]
    train_mb = len(EpochPlan(PackedDataset(str(train_npz)), batch_size=B, seed=1337, epoch=1))
    val_mb = len(EpochPlan(PackedDataset(str(val_npz)), batch_size=B, seed=1337, epoch=0,
                           shuffle=False))
    config = run_yaml(workdir / "hybrid.yaml", train_npz, val_npz, G=HYBRID_G,
                      epochs=HYBRID_EPOCHS, run_id="smoke-hybrid")
    for w in FLASH_WRAPPERS:
        w.launches = 0  # the hybrid run's launches only
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli(["--config", str(config), "--run_root", str(workdir / "runs")])
    train_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    hybrid_run = workdir / "runs" / "smoke-hybrid"
    with (hybrid_run / "scores" / "curves.csv").open() as f:
        curves = list(csv.DictReader(f))
    train_losses = [float(r["train_loss"]) for r in curves]
    val_losses = [float(r["val_loss"]) for r in curves]
    meta = json.loads((hybrid_run / "checkpoints" / "meta.json").read_text())
    vocab = meta["model_spec"]["vocab_size"]
    want_bwd = L * train_mb * HYBRID_EPOCHS
    want_fwd = want_bwd + L * val_mb * HYBRID_EPOCHS

    # the flash kernels on the first microbatch of the train split, its own segments
    xb = torch.from_numpy(X[:B]).cuda().long()
    seg = segment_ids(xb, train_main.MAIN_TRAIN["sep_id"])
    n_segments = int((seg[:, -1] - seg[:, 0] + 1).sum())
    width = train_main.MAIN_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(16)
    timed = check_flash_case(gen, "hybrid_flash", "hybrid_b8_bf16_dropout", B, width["n_head"],
                             width["n_head"], train_main.T, train_main.T,
                             width["n_embd"] // width["n_head"], torch.bfloat16, None,
                             width["dropout"], seg, True, peak_bw, peak_ops)
    row = dict(prepare_rc=0, prepare_s=prepare_s, integrity=integrity["empty_windows"],
               itos_lines=len(itos), windows=dict(train=int(X.shape[0]), val=n_val),
               stages=len(result["stages"]), prepared=printed.strip().splitlines()[-1],
               config=f"10L8H d384 block 512 bf16 flash dropout 0.1, B {B} x G {HYBRID_G}, "
                      f"{HYBRID_EPOCHS} epochs", rc=rc, train_s=train_s, vocab_size=vocab,
               train_losses=train_losses, val_losses=val_losses, ln_vocab=math.log(HYBRID_VOCAB),
               train_microbatches=train_mb, val_microbatches=val_mb, flash_launches=launches,
               want_fwd=want_fwd, want_bwd=want_bwd, microbatch_segments=n_segments,
               microbatch_unk=int((xb == 3).sum()), card=card)
    log("hybrid_train", **row)
    if any(v != 0 for v in integrity["empty_windows"].values()) or len(itos) != HYBRID_VOCAB:
        raise AssertionError(f"hybrid preparation: {integrity}, {len(itos)} itos lines")
    if rc != 0 or vocab != HYBRID_VOCAB or len(curves) != HYBRID_EPOCHS:
        raise AssertionError(f"hybrid run: rc {rc}, vocab {vocab}, {len(curves)} epochs")
    if not all(np.isfinite(train_losses + val_losses)) or val_losses[-1] >= math.log(
            HYBRID_VOCAB):
        raise AssertionError(f"hybrid losses: {train_losses}, {val_losses}")
    if (launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] != want_bwd
            or launches["flash_bwd_dkv"] != want_bwd):
        raise AssertionError(f"hybrid flash launches {launches}: want fwd {want_fwd}, "
                             f"dq/dkv {want_bwd}")
    return {"launches": launches, "timed": timed, "run_dir": hybrid_run}


# --- phases 50-53: the training layer's last modules ----------------------------

# Adafactor statistics against the one rank's: each is a mean of g² (+ 1e-30),
# so its relative error is about twice the gradient's (grad_rtol); a leaf whose
# gradient is rounding noise is held at the noise floor's square
ADAFACTOR_STAT_RTOL = 2 * TRAIN_PARITY_TOL["grad_rtol"]
# the weights: TRAIN_PARITY_TOL, but a parameter whose gradient is rounding
# noise takes Adafactor's first unfactored step lr * g / |g| = +-lr on either
# side, so it is held to two steps at the run's lr plus the float32 rounding of
# the weight it is added to (1e-6); a missing or doubled step of a real
# gradient still fails param_atol
ADAFACTOR_TP_TOL = dict(TRAIN_PARITY_TOL,
                        noise_param_atol=2 * train_main.RUN_CFG["lr"] + 1e-6)


def phase_tp_adafactor(card: str, par: dict) -> dict:
    """``[tp_adafactor]``: the float32 group of ``[tp_train]``'s parity (2
    layers at the full width d384, a depth cut; dropout 0; uneven pad) under
    ``optimizer: adafactor`` at tensor parallel 2 with sequence parallelism,
    on the two gloo ranks of ``phase_parallel_ranks``, against the one-rank
    Adafactor group in the NCCL process: the loss, gradients and updated
    weights within ``ADAFACTOR_TP_TOL`` (``TRAIN_PARITY_TOL`` with Adafactor's
    noise rule: a rounding-noise gradient's first unfactored step is
    lr * g / |g| of either sign), and every statistic, each rank's slices
    merged into the JAX leaves, within ``ADAFACTOR_STAT_RTOL``. At d384 no
    factored leaf falls under optax's 128 when split in two (a rank's
    (L, 192, 384)), so the trap of reading the factoring from a rank's shape
    shows only in the CPU test (``tests/test_torch_adafactor_tp.py``, d128)."""
    ref, got = par["ada_ref"], par["tp_adafactor"][0]
    parity = compare_group("tp_adafactor", "gloo_tp2_sp_f32_adafactor", par["f32_kw"], ref, got,
                           ADAFACTOR_TP_TOL)
    want, have = ref["optimizer"], got["optimizer"]
    if want["format"] != have["format"] or want["count"] != have["count"] != 1:
        raise AssertionError(f"Adafactor state: {have['format']} {have['count']}")
    if set(want["state"]) != set(have["state"]):
        raise AssertionError("the merged Adafactor state holds other leaves")
    floor = TRAIN_PARITY_TOL["noise_grad_share"] ** 2 * max(
        float(np.abs(v).max()) for st in want["state"].values() for v in st.values())
    worst, factored = (0.0, ""), 0
    for path, st in want["state"].items():
        if set(st) != set(have["state"][path]):
            raise AssertionError(f"{path}: statistics {set(have['state'][path])}, want {set(st)}")
        factored += "v_row" in st
        for key, w in st.items():
            g, w = np.asarray(have["state"][path][key]), np.asarray(w)
            if g.shape != w.shape:
                raise AssertionError(f"{path}/{key}: shape {g.shape}, want {w.shape}")
            err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), floor)
            worst = max(worst, (err, f"{path}/{key}"))
    log("tp_adafactor", leaves=len(want["state"]), factored_leaves=factored,
        stat_rel_err=worst[0], stat_worst_leaf=worst[1], tol=ADAFACTOR_STAT_RTOL,
        seconds=got["seconds"], collectives=got["collectives"], card=card)
    if worst[0] > ADAFACTOR_STAT_RTOL or factored == 0:
        raise AssertionError(f"Adafactor statistics off by {worst}")
    return {"parity": parity, "stat_rel_err": worst[0]}


ENGINE_G, ENGINE_MICRO, ENGINE_EPOCHS = 4, 8, 2  # 2 groups an epoch
ENGINE_VAL_MICRO = 2
ENGINE_NAN = (1, 5)  # (epoch, microbatch) whose loss is made NaN: its group aborts


class EngineLMTask:
    """The training main path's model as a ``training/engine.py`` task:
    synthetic windows (``profile_step.make_batch``: ``<SEP>`` every 97th),
    the loss of ``forward`` (bf16 flash, dropout 0.1 on ``gen``), its
    gradients from ``torch.autograd.grad``; AdamW applies what the strategy
    hands back. Its state is the weights, AdamW's and the generator's."""

    def __init__(self, model, cfg, opt, gen):
        self.model, self.cfg, self.opt, self.gen = model, cfg, opt, gen
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.microbatches = self.val_microbatches = 0

    def train_batches(self, epoch):
        batch = train_main.make_batch(100 + epoch, "cuda", groups=ENGINE_MICRO)
        for i in range(ENGINE_MICRO):
            yield epoch, i, batch["x"][i], batch["y"][i]

    def training_step(self, batch):
        epoch, i, x, y = batch
        _, loss = model_forward(self.model, self.cfg, x, y, train=True, generator=self.gen)
        if (epoch, i) == ENGINE_NAN:
            loss = loss * float("nan")
        grads = torch.autograd.grad(loss, self.params)
        self.microbatches += 1
        return engine_lib.StepOutput(loss=float(loss.detach()),
                                     grads=dict(zip(self.names, grads)))

    def apply_updates(self, grads):
        for name, p in zip(self.names, self.params):
            p.grad = grads[name]
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def val_batches(self):
        batch = train_main.make_batch(7, "cuda", groups=ENGINE_VAL_MICRO)
        for i in range(ENGINE_VAL_MICRO):
            yield batch["x"][i], batch["y"][i]

    @torch.no_grad()
    def validation_step(self, batch):
        x, y = batch
        _, loss = model_forward(self.model, self.cfg, x, y)
        self.val_microbatches += 1
        return {"val_loss": engine_lib.MetricValue(float(loss), weight=float((y != 0).sum()))}

    def state_dict(self):
        return {"model": [p.detach().clone() for p in self.params],
                "opt": copy.deepcopy(self.opt.state_dict()), "gen": self.gen.get_state()}

    @torch.no_grad()
    def load_state_dict(self, state):
        for p, saved in zip(self.params, state["model"]):
            p.copy_(saved)
        self.opt.load_state_dict(copy.deepcopy(state["opt"]))
        self.gen.set_state(state["gen"])


class GroupClock:
    """An engine callback: each group's wall seconds, from the previous
    group's end (or the validation's) to this one's commit or abort, the
    queue drained by ``utils/sync.py::hard_sync`` at both ends; and every
    event, for the streams to be compared."""

    def __init__(self, model):
        self.model, self.seconds, self.events = model, [], []
        self.mark = self._now()

    def _now(self) -> float:
        hard_sync(self.model)
        return time.perf_counter()

    def on_event(self, name, payload):
        self.events.append((name, payload))
        if name in ("group_committed", "group_aborted"):
            now = self._now()
            self.seconds.append(now - self.mark)
            self.mark = now
        elif name == "validation_completed":
            self.mark = self._now()


def engine_run(state=None, wall_timer=None):
    """A fresh main-path model, AdamW and generator (seeded), its task
    through ``TrainingEngine`` (G ``ENGINE_G``, ``ENGINE_EPOCHS`` epochs),
    restored from ``state`` (a saved payload) when given; returns the task,
    the engine, the clock and the saved payloads."""
    cfg = CodonGPTConfig(**train_main.MAIN_TRAIN)
    torch.manual_seed(train_main.SEED)
    model = CodonGPT(cfg).cuda().train()
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.05)
    gen = torch.Generator(device="cuda").manual_seed(train_main.SEED)
    task = EngineLMTask(model, cfg, opt, gen)
    clock, saved = GroupClock(model), []
    strategy = engine_lib.AccumulatedGradsStrategy(task.apply_updates, grad_clip=1.0)
    eng = engine_lib.TrainingEngine(task, strategy, group_size=ENGINE_G,
                                    max_epochs=ENGINE_EPOCHS, wall_timer=wall_timer,
                                    save_fn=saved.append, callbacks=[clock])
    if state is not None:
        eng.restore(state)
    eng.fit()
    return task, eng, clock, saved


class ExpireAt(WallTimer):
    """A wall timer that expires at its ``checks``-th check (the engine
    checks once a microbatch): here as the first group commits."""

    def __init__(self, checks: int):
        super().__init__(None)
        self.calls, self.checks = 0, checks

    def expired(self) -> bool:
        self.calls += 1
        return self.calls >= self.checks


def phase_engine(card: str) -> dict:
    """``[engine]``: ``training/engine.py`` at the main path's width (10L8H
    d384, bf16 flash, dropout 0.1; B 8 x T 512 synthetic windows, ``<SEP>``
    every 97th), G 4, 2 epochs of 8 microbatches, AdamW, ``grad_clip`` 1.0;
    microbatch 6 of epoch 1 gives a NaN loss, so its group aborts and its
    last microbatch is skipped. The run straight once; then again with a
    wall-time stop as group 1 commits, a restore of the saved payload into a
    fresh model, optimizer and generator, and a resume: the final weights
    bit for bit the straight run's, and every group and validation event
    equal (under torch's deterministic algorithms, for the embedding
    gradient's sums). Groups timed with ``hard_sync``. The flash launches
    (reset before the straight run, read after the resume) 10 per
    microbatch run, the forward's also 10 per validation microbatch."""
    for w in FLASH_WRAPPERS:
        w.launches = 0
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        straight, eng, clock, _ = engine_run()
        straight_s = time.perf_counter() - t0
        stopped, _, clock1, saved = engine_run(wall_timer=ExpireAt(ENGINE_G))
        t0 = time.perf_counter()
        resumed, eng2, clock2, _ = engine_run(state=saved[-1])
        resume_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    L = train_main.MAIN_TRAIN["n_layer"]
    micro = straight.microbatches + stopped.microbatches + resumed.microbatches
    val = straight.val_microbatches + stopped.val_microbatches + resumed.val_microbatches
    want_bwd, want_fwd = L * micro, L * (micro + val)
    same = all(torch.equal(a, b) for a, b in zip(straight.params, resumed.params))
    keep = ("group_committed", "group_aborted", "validation_completed")
    events = [e for e in clock.events if e[0] in keep]
    stitched = [e for e in clock1.events + clock2.events if e[0] in keep]
    aborted = [p for n, p in clock.events if n == "group_aborted"]
    history = eng.history
    tokens = int(ENGINE_MICRO * train_main.B * train_main.T)
    m = train_main.MAIN_TRAIN
    row = dict(config=f"{m['n_layer']}L{m['n_head']}H d{m['n_embd']} bf16 flash dropout "
                      f"{m['dropout']}, B {train_main.B} x T {train_main.T}, G {ENGINE_G}, "
                      f"{ENGINE_EPOCHS} epochs of {ENGINE_MICRO}",
               history=history, aborted=aborted, optimizer_steps=eng.state.optimizer_step,
               group_ms=[round(t * 1e3, 2) for t in clock.seconds],
               straight_s=straight_s, resume_s=resume_s, saved=saved[-1]["metadata"],
               saved_engine=saved[-1]["engine"], resumed_bit_equal=same,
               events_equal=events == stitched, microbatches_run=micro,
               val_microbatches=val, flash_launches=launches, want_fwd=want_fwd,
               want_bwd=want_bwd, tokens_per_epoch=tokens, card=card)
    log("engine", **row)
    if len(history) != ENGINE_EPOCHS or not all(np.isfinite(
            [h["train_loss"] for h in history] + [h["val_loss"] for h in history])):
        raise AssertionError(f"engine history {history}")
    if aborted != [{"epoch": 1, "microbatch": ENGINE_NAN[1] + 1, "discarded": 1}]:
        raise AssertionError(f"engine aborts {aborted}")
    if eng.state.optimizer_step != ENGINE_EPOCHS * ENGINE_MICRO // ENGINE_G - 1:
        raise AssertionError(f"engine committed {eng.state.optimizer_step} groups")
    if saved[-1]["metadata"]["reason"] != "wall_time" or saved[-1]["engine"]["microbatch"] != (
            ENGINE_G):
        raise AssertionError(f"the wall-time save: {saved[-1]['engine']}")
    if not same or events != stitched or eng2.history[-1] != history[-1]:
        raise AssertionError("the stopped and resumed engine run is not the straight run")
    if (launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] != want_bwd
            or launches["flash_bwd_dkv"] != want_bwd):
        raise AssertionError(f"engine flash launches {launches}: want fwd {want_fwd}, "
                             f"dq/dkv {want_bwd}")
    return {"launches": launches, "group_ms": row["group_ms"]}


# train_encoder's defaults (the CLI's own are 5000 x 50 codons, 10 epochs)
FUSION_ENCODER = ["--num_samples", "2000", "--seq_len_codons", "32", "--epochs", "5"]
FUSION_GROUPS_PER_EPOCH, FUSION_G, FUSION_EPOCHS = 4, 2, 2
FUSION_VAL_WINDOWS = SCORE_CPU_WINDOWS  # one validation microbatch; the CPU scores them too


def phase_biophysics_fusion(workdir: Path, card: str) -> dict:
    """``[biophysics_fusion]``: the fusion CLI (``training/train_biophysics_fusion.py``)
    on the card: the shape encoder fit at ``train_encoder``'s defaults (2000
    sequences of 32 codons, 5 epochs, batch 64; its loss must fall), saved,
    then the chained shape-guided run of the train CLI's loop at the main
    path's width (``run_yaml``: 10L8H d384, bf16 flash, dropout 0.1) on a
    packed corpus (``FUSION_GROUPS_PER_EPOCH`` G 2 groups an epoch, 8
    validation windows), 2 epochs with ``save_epochs``: its encoder frozen as
    fitted, every loss finite, the epoch checkpoints written, and each flash
    kernel's launches (reset just before, read just after) 10 per
    microbatch, the forward's also 10 per validation microbatch."""
    from genomics_lm_torch.training.train_biophysics_fusion import main as fusion_cli

    B, L = train_main.B, train_main.MAIN_TRAIN["n_layer"]
    packed_corpus(workdir, FUSION_GROUPS_PER_EPOCH * FUSION_G * B, FUSION_VAL_WINDOWS)
    config = run_yaml(workdir / "fusion.yaml", workdir / "train.npz", workdir / "val.npz",
                      G=FUSION_G, epochs=FUSION_EPOCHS, run_id="smoke-fusion")
    config.write_text(config.read_text() + "save_epochs: true\n")
    encoder = workdir / "shape_encoder.npz"
    for w in FLASH_WRAPPERS:
        w.launches = 0  # the fusion CLI's run only
    cwd = Path.cwd()
    t0 = time.perf_counter()
    try:  # the chained trainer writes under runs/ of the working directory, as JAX's
        os.chdir(workdir)
        printed = _run_cli(fusion_cli, ["--out_checkpoint", str(encoder), *FUSION_ENCODER,
                                        "--lm_config", str(config), "--device", "cuda:0"])
    finally:
        os.chdir(cwd)
    cli_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    fitted = load_checkpoint(encoder)
    run_dir = workdir / "runs" / "smoke-fusion"
    with (run_dir / "scores" / "curves.csv").open() as f:
        curves = list(csv.DictReader(f))
    train_losses = [float(r["train_loss"]) for r in curves]
    val_losses = [float(r["val_loss"]) for r in curves]
    last = load_checkpoint(run_dir / "checkpoints" / "last.npz", keys=("cfg", "model"))
    frozen = all(np.array_equal(np.asarray(last["model"]["shape_encoder"][c][k]),
                                np.asarray(fitted["encoder"][c][k]))
                 for c in ("conv1", "conv2") for k in ("w", "b"))
    epochs = sorted(p.name for p in (run_dir / "checkpoints").glob("epoch_*.npz"))
    train_mb = FUSION_GROUPS_PER_EPOCH * FUSION_G
    want_bwd = L * train_mb * FUSION_EPOCHS
    want_fwd = want_bwd + L * -(-FUSION_VAL_WINDOWS // B) * FUSION_EPOCHS
    row = dict(encoder=dict(samples=2000, codons=32, epochs=5, losses=fitted["losses"]),
               config=f"{L}L{train_main.MAIN_TRAIN['n_head']}H d{train_main.MAIN_TRAIN['n_embd']}"
                      f" bf16 flash dropout 0.1, shape guidance, B {B} x G {FUSION_G}, "
                      f"{FUSION_EPOCHS} epochs",
               cli_s=cli_s, train_losses=train_losses, val_losses=val_losses,
               use_shape_guidance=last["cfg"].get("use_shape_guidance"),
               encoder_frozen=frozen, epoch_checkpoints=epochs, flash_launches=launches,
               want_fwd=want_fwd, want_bwd=want_bwd,
               printed=printed.strip().splitlines()[0], card=card)
    log("biophysics_fusion", **row)
    losses = fitted["losses"]
    if len(losses) != 5 or not losses[-1] < losses[0]:
        raise AssertionError(f"the encoder's loss did not fall: {losses}")
    if not (last["cfg"].get("use_shape_guidance") and frozen) or len(epochs) != FUSION_EPOCHS:
        raise AssertionError(f"the shape-guided run: {row}")
    if len(curves) != FUSION_EPOCHS or not all(np.isfinite(train_losses + val_losses)):
        raise AssertionError(f"the shape-guided losses: {train_losses}, {val_losses}")
    if (launches["flash_fwd"] != want_fwd or launches["flash_bwd_dq"] != want_bwd
            or launches["flash_bwd_dkv"] != want_bwd):
        raise AssertionError(f"fusion flash launches {launches}: want fwd {want_fwd}, "
                             f"dq/dkv {want_bwd}")
    return {"launches": launches, "run_dir": run_dir, "val_npz": workdir / "val.npz",
            "runs": workdir / "runs"}


@contextlib.contextmanager
def counted_calls(module, name: str):
    """Calls of ``module.<name>`` while the block runs (callers that look the
    name up in the module at call time: the cached decoder's
    ``decode_step``, the speculative loop's ``_speculative_round``)."""
    fn, calls = getattr(module, name), [0]

    def counting(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counting)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def run_timed(secs: dict, launches: dict, name: str, cli, argv, predictions=None) -> str:
    """One CLI with the flash and decode kernels' launches set to 0 just before
    it and read just after (this tool's run only): its seconds, launches and
    cached decode steps go into ``secs`` and ``launches`` under ``name``, and,
    when ``predictions`` is given, the classes of its last bootstrap report."""
    fa.flash_fwd.launches = 0
    da.decode_attention.launches = 0
    calls = []
    t0 = time.perf_counter()
    with counted_calls(decode_mod, "decode_step") as steps, contextlib.ExitStack() as stack:
        if predictions is not None:
            stack.enter_context(recorded_predictions(calls))
        printed = _run_cli(cli, argv)
    secs[name] = time.perf_counter() - t0
    launches[name] = {"flash_fwd": fa.flash_fwd.launches,
                      "decode_attention": da.decode_attention.launches,
                      "decode_steps": steps[0]}
    if calls:
        predictions[name] = calls[-1]
    return printed


def phase_run_tools(demo: dict, fusion: dict, prepared: dict, workdir: Path,
                    card: str) -> dict:
    """``[run_tools]``: ``training/training_preflight.py`` on the card;
    ``evals/eval_epoch_sweep.py`` and ``evals/compare_checkpoints.py`` over
    ``[biophysics_fusion]``'s two epoch checkpoints on its 8 validation
    windows (the flash forward 10 a checkpoint), the same NLLs from both, and
    the last epoch's NLL on the card against the CPU (both float32, TF32 off)
    within ``SCORE_NLL_RTOL``; ``evals/sanity_kpis.py`` on ``[demo_run]``'s
    run and the block-512 demo validation split (the flash forward 10 a
    microbatch of 32 and 10 for the embedding; constrained generation from
    ATG through the cached decoder at B 1: the decode kernel 10 a decode
    step), every check passed. (Not on ``[trainer]``'s run: 12 steps on
    uniform random codons leave its validation loss near 18.7, so its
    perplexity does not beat the uniform one and the KPIs rightly fail.)
    then host only: ``evals/compare_runs.py`` over the fusion run's root,
    and ``data/freeze_corrected_datasets.py --read_only`` of ``[prepare]``'s
    two datasets with ``data/verify_dataset_freeze.py`` on the release."""
    import hashlib
    import stat

    from genomics_lm_torch.data.freeze_corrected_datasets import main as freeze_cli
    from genomics_lm_torch.data.verify_dataset_freeze import main as verify_cli
    from genomics_lm_torch.evals.compare_checkpoints import main as compare_cli
    from genomics_lm_torch.evals.compare_runs import main as compare_runs_cli
    from genomics_lm_torch.evals.eval_epoch_sweep import main as sweep_cli
    from genomics_lm_torch.evals.eval_epoch_sweep import score_checkpoint
    from genomics_lm_torch.evals.sanity_kpis import main as kpis_cli
    from genomics_lm_torch.training.training_preflight import run_preflight

    L = train_main.MAIN_TRAIN["n_layer"]
    secs = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        preflight = run_preflight(workdir / "preflight", device="cuda:0")
    secs["preflight"] = time.perf_counter() - t0

    run_dir, val = fusion["run_dir"], fusion["val_npz"]
    sweep_json = workdir / "epoch_sweep.json"
    fa.flash_fwd.launches = 0  # the sweep's
    t0 = time.perf_counter()
    _run_cli(sweep_cli, [str(run_dir), "--npz", str(val), "--out", str(sweep_json),
                         "--device", "cuda:0"])
    secs["sweep"] = time.perf_counter() - t0
    sweep_launches = fa.flash_fwd.launches
    sweep = json.loads(sweep_json.read_text())
    ckpts = [str(run_dir / "checkpoints" / r["checkpoint"]) for r in sweep]
    fa.flash_fwd.launches = 0  # the comparison's
    t0 = time.perf_counter()
    printed = _run_cli(compare_cli, [*ckpts, "--npz", str(val), "--device", "cuda:0"])
    secs["compare_checkpoints"] = time.perf_counter() - t0
    compare_launches = fa.flash_fwd.launches
    compared = json.loads(printed[: printed.index("[compare]")])
    by_name = {Path(r["checkpoint"]).name: r for r in compared}
    per_ckpt = L * -(-FUSION_VAL_WINDOWS // 32)
    sweep_vs_compare = max(abs(by_name[r["checkpoint"]]["nll"] - r["nll"]) / abs(r["nll"])
                           for r in sweep)

    # the last epoch's NLL, float32 (TF32 off), on the card and on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = {}
    t0 = time.perf_counter()
    for device in ("cuda:0", "cpu"):
        payload = load_checkpoint(ckpts[-1], keys=("cfg", "model"))
        cfg = CodonGPTConfig.from_run_config(payload["cfg"]).replace(
            compute_dtype="float32", dropout=0.0)
        model = params_from_jax(payload["model"], cfg, device).eval()
        f32[device] = ppl.evaluate_perplexity(model, cfg, val, batch_size=FUSION_VAL_WINDOWS)["nll"]
        del model
    secs["card_vs_cpu"] = time.perf_counter() - t0
    card_cpu_err = abs(f32["cuda:0"] - f32["cpu"]) / abs(f32["cpu"])

    kpis_json = workdir / "sanity_kpis.json"
    fa.flash_fwd.launches = 0
    da.decode_attention.launches = 0  # the KPIs' run only
    t0 = time.perf_counter()
    with counted_calls(decode_mod, "decode_step") as steps:
        _run_cli(kpis_cli, [str(demo["run_dir"]), "--val_npz", str(demo["val_npz"]),
                            "--out", str(kpis_json), "--device", "cuda:0"])
    secs["sanity_kpis"] = time.perf_counter() - t0
    kpis = json.loads(kpis_json.read_text())
    kpi_launches = {"flash_fwd": fa.flash_fwd.launches,
                    "decode_attention": da.decode_attention.launches, "decode_steps": steps[0]}
    with np.load(demo["val_npz"]) as z:
        kpi_val_mb = -(-int(z["X"].shape[0]) // 32)
    want_kpi_fwd = L * (kpi_val_mb + 1)  # perplexity, then one embedding batch

    t0 = time.perf_counter()
    printed = _run_cli(compare_runs_cli, ["--root", str(fusion["runs"])]).splitlines()
    # the rows' JSON, after the line that says the chart is not drawn without matplotlib
    first = next(i for i, line in enumerate(printed) if line in ("[", "[]"))
    last = next(i for i, line in enumerate(printed) if line.startswith("[compare]"))
    summary_rows = json.loads("\n".join(printed[first:last]))
    secs["compare_runs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    release = workdir / "corrected" / "smoke-v1"
    _run_cli(freeze_cli, ["--release", "smoke-v1", "--out_root", str(workdir / "corrected"),
                          "--read_only", "--protocol", "p256", str(prepared[256]["dir"]),
                          "--protocol", "p512", str(prepared[512]["dir"])])
    verified = _run_cli(verify_cli, [str(release)]).strip()
    secs["freeze_verify"] = time.perf_counter() - t0
    freeze = json.loads((release / "freeze.json").read_text())
    ids = {"p256": prepared[256]["ids"][0], "p512": prepared[512]["ids"][0]}
    want_id = hashlib.sha256(json.dumps(ids, sort_keys=True).encode()).hexdigest()
    modes = {stat.S_IMODE(p.stat().st_mode) for p in release.rglob("*")
             if p.is_file() and p.name != "freeze.json"}

    row = dict(preflight=preflight["checks"], preflight_passed=preflight["passed"],
               sweep=sweep, sweep_vs_compare_rel=sweep_vs_compare,
               card_vs_cpu_f32=dict(card=f32["cuda:0"], cpu=f32["cpu"], rel_err=card_cpu_err,
                                    tol=SCORE_NLL_RTOL),
               sweep_launches=sweep_launches, compare_launches=compare_launches,
               want_per_checkpoint=per_ckpt, kpis=kpis, kpi_launches=kpi_launches,
               want_kpi_fwd=want_kpi_fwd, summary_rows=summary_rows,
               freeze_id=freeze["dataset_freeze_id"], freeze_id_expected=want_id,
               release_modes=sorted(oct(m) for m in modes), verify=verified,
               seconds=secs, card=card)
    log("run_tools", **row)
    if not preflight["passed"] or not kpis["passed"]:
        raise AssertionError(f"preflight {preflight['checks']} or KPIs {kpis['checks']} failed")
    if len(sweep) != FUSION_EPOCHS or sweep_vs_compare > 1e-6 or not all(
            np.isfinite([r["nll"] for r in sweep])):
        raise AssertionError(f"the sweep {sweep} and the comparison {compared} disagree")
    if card_cpu_err > SCORE_NLL_RTOL:
        raise AssertionError(f"the card's NLL differs from the CPU's: {f32}")
    if sweep_launches != per_ckpt * len(sweep) or compare_launches != per_ckpt * len(sweep):
        raise AssertionError(f"sweep/compare flash launches {sweep_launches}/{compare_launches},"
                             f" want {per_ckpt * len(sweep)}")
    if (kpi_launches["flash_fwd"] != want_kpi_fwd or kpi_launches["decode_steps"] == 0
            or kpi_launches["decode_attention"] != L * kpi_launches["decode_steps"]):
        raise AssertionError(f"KPI launches {kpi_launches}, want flash {want_kpi_fwd}")
    if not any(r["run_id"] == "smoke-fusion" and r["complete"] for r in summary_rows):
        raise AssertionError(f"compare_runs rows {summary_rows}")
    if (freeze["dataset_freeze_id"] != want_id or modes != {0o444}
            or not verified.startswith("[verify] OK")):
        raise AssertionError(f"the freeze: {freeze}, modes {modes}, {verified}")
    return {"flash": sweep_launches + compare_launches + kpi_launches["flash_fwd"],
            "decode": kpi_launches["decode_attention"]}


# --- phases 53-55: the timing tools, the run diagnoses, the speed sweep ---------

PROFILE_TRAIN_STEPS = 2  # of profile_train's 5, for the smoke's time
DECODE_BENCH = ["--decode_tokens", "32", "--measure_rounds", "1"]  # of 128 tokens, 3 rounds
DECODE_BENCH_MODES = {"scan": [], "stepwise": ["--mode", "stepwise", "--donate_cache"],
                      "speculative": ["--speculative", "4"]}
SPEED_CANDIDATE = "8x16"
DMS_VARIANTS = 24


def trace_device_share(trace_dir: Path) -> dict:
    """Kernel time in a ``torch.profiler`` Chrome trace against the span of
    its profiler steps: (device ms, wall ms, kernels)."""
    path = max(trace_dir.glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    return {"trace": path.name, "trace_bytes": path.stat().st_size,
            "device_ms": sum(e["dur"] for e in kernels) / 1e3, "span_ms": (end - start) / 1e3,
            "kernels": len(kernels)}


def start_speed_sweep(workdir: Path) -> dict:
    """Start ``training/benchmark_training_speed.py --candidates 8x16
    --measure_steps 2`` as a process of its own (the user's command line):
    its probe takes ~20 s to reach the card and take its four groups, which
    phases 53 and 54 overlap; ``phase_speed_sweep`` joins it."""
    out = workdir / "training_speed.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "genomics_lm_torch.training.benchmark_training_speed",
         "--candidates", SPEED_CANDIDATE, "--measure_steps", "2", "--out", str(out)],
        cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "out": out, "t0": time.perf_counter()}


def stop_speed_sweep(sweep: dict) -> None:
    if sweep["proc"].poll() is None:
        sweep["proc"].kill()
    sweep["proc"].communicate()


def phase_speed_sweep(sweep: dict, card: str) -> dict:
    """``[speed_sweep]``: the sweep started before phase 53, joined: its one
    probe ran on the card (``ok``, the card's peak memory nonzero) and loaded
    the flash library from the build cache (its ``[probe]`` line), without a
    rebuild. Its tokens/s were taken while phases 53-54 ran on the same card:
    a record of the run, not a clean figure."""
    t0 = time.perf_counter()
    log_text, _ = sweep["proc"].communicate(timeout=600)
    waited = time.perf_counter() - t0
    if sweep["proc"].returncode != 0:
        raise AssertionError(f"the speed sweep exited {sweep['proc'].returncode}: "
                             f"{log_text[-2000:]}")
    speed = json.loads(sweep["out"].read_text())
    probe_lines = [line for line in log_text.splitlines() if line.startswith("[probe]")]
    log("speed_sweep", speed=speed, probe_log=probe_lines, waited_s=waited,
        started_s_before=time.perf_counter() - sweep["t0"], card=card)
    result = speed["results"][0] if speed["results"] else {}
    if (not result.get("ok") or speed["selected_policy"]["name"] != f"b{SPEED_CANDIDATE}"
            or not result["device_memory"].get("peak_bytes_in_use")):
        raise AssertionError(f"the speed sweep: {speed}\n{log_text[-2000:]}")
    if len(probe_lines) != 1 or "loaded from the build cache" not in probe_lines[0]:
        raise AssertionError(f"the speed probe rebuilt or did not load the kernels: {log_text}")
    return speed


def phase_timing_tools(trained: dict, served: dict, workdir: Path, card: str) -> dict:
    """``[timing_tools]``: ``training/profile_train.py`` at its defaults but
    ``--steps 2`` (10L8H d384, B 32 x G 4 x T 512, bf16 flash on the card):
    flash launches 10 x 4 a step for each kernel, the warm step included, a
    trace in its directory, its tokens/s beside ``[train]``'s, and the
    trace's kernel time against its span; ``serving/benchmark_decode.py`` at
    its defaults but 32 tokens and one measured round in ``scan``,
    ``stepwise --donate_cache`` and ``--speculative 4``: decode launches 10 a
    cached step, chunk launches 10 a verify round, no flash launch (the
    prompt's attention is the plain path, as in JAX's ``prefill``), ms a
    step beside ``[serve]``'s; ``make_run_id`` and ``hardware_monitor
    --device``. (The speed sweep's probe runs beside it: ``start_speed_sweep``.)"""
    from genomics_lm_torch.serving.benchmark_decode import main as decode_bench_cli
    from genomics_lm_torch.training.make_run_id import main as run_id_cli
    from genomics_lm_torch.training.profile_train import main as profile_cli
    from genomics_lm_torch.utils.hardware_monitor import main as monitor_cli

    L = train_main.MAIN_TRAIN["n_layer"]
    secs = {}
    profile_dir = workdir / "profile"
    for w in FLASH_WRAPPERS:
        w.launches = 0  # profile_train's run only
    t0 = time.perf_counter()
    _run_cli(profile_cli, ["--out_dir", str(profile_dir), "--steps", str(PROFILE_TRAIN_STEPS)])
    secs["profile_train"] = time.perf_counter() - t0
    profile_launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    summary = (profile_dir / "summary.txt").read_text().splitlines()
    tokens_per_s = float(next(line for line in summary
                              if line.startswith("nonpad tokens/sec:")).split(":")[1])
    t0 = time.perf_counter()
    trace = trace_device_share(profile_dir)
    secs["trace_read"] = time.perf_counter() - t0

    decode = {}
    for mode, flags in DECODE_BENCH_MODES.items():
        da.decode_attention.launches = 0  # this run's only
        da.decode_attention_chunk.launches = 0
        fa.flash_fwd.launches = 0
        t0 = time.perf_counter()
        with (counted_calls(decode_mod, "decode_step") as steps,
              counted_calls(spec_mod, "_speculative_round") as rounds):
            out = _run_cli(decode_bench_cli, [*DECODE_BENCH, *flags])
        report = json.loads(out.strip().splitlines()[-1])
        decode[mode] = dict(report=report, seconds=time.perf_counter() - t0,
                            decode_steps=steps[0], verify_rounds=rounds[0],
                            decode_launches=da.decode_attention.launches,
                            chunk_launches=da.decode_attention_chunk.launches,
                            flash_launches=fa.flash_fwd.launches)
    secs["benchmark_decode"] = sum(d["seconds"] for d in decode.values())

    t0 = time.perf_counter()
    config = workdir / "stage2_smoke.yaml"
    config.write_text("n_layer: 10\nn_head: 8\nn_embd: 384\nepochs: 2\n")
    run_id = _run_cli(run_id_cli, [str(config)]).strip()
    monitor = _run_cli(monitor_cli, ["--device", "--iterations", "1", "--interval", "0"]).strip()
    secs["run_tools"] = time.perf_counter() - t0

    row = dict(profile_summary=summary, profile_launches=profile_launches,
               profile_tokens_per_s=tokens_per_s,
               train_tokens_per_s=trained["nonpad_tokens_per_s"], trace=trace,
               trace_device_share=trace["device_ms"] / trace["span_ms"], decode=decode,
               serve_ms_per_decode_step=served["ms_per_decode_step"][False], run_id=run_id,
               monitor=monitor, seconds=secs, card=card)
    log("timing_tools", **row)
    want = L * 4 * (1 + PROFILE_TRAIN_STEPS)  # 10 layers x G 4, the warm step included
    if any(n != want for n in profile_launches.values()):
        raise AssertionError(f"profile_train flash launches {profile_launches}, want {want}")
    if len(summary) != 7 or not trace["kernels"] or not np.isfinite(tokens_per_s):
        raise AssertionError(f"profile_train: {summary}, trace {trace}")
    for mode, d in decode.items():
        if (d["decode_launches"] != L * d["decode_steps"] or d["decode_steps"] == 0
                or d["chunk_launches"] != L * d["verify_rounds"] or d["flash_launches"]
                or (mode == "speculative") != (d["verify_rounds"] > 0)
                or not d["report"]["value"] > 0):
            raise AssertionError(f"benchmark_decode {mode}: {d}")
    if not run_id.endswith("_stage2_10L8H_d384_e2") or " hbm=" not in monitor:
        raise AssertionError(f"make_run_id {run_id!r}, hardware_monitor {monitor!r}")
    return {"profile": profile_launches,
            "decode": sum(d["decode_launches"] for d in decode.values()),
            "chunk": sum(d["chunk_launches"] for d in decode.values())}


def head_run(demo_run: Path, workdir: Path) -> Path:
    """A run directory holding the demo run's weights and a termination head
    from the port's seeded init (the head's cfg on), written through
    ``training/checkpoints.py``."""
    from genomics_lm_torch.training.checkpoints import save_checkpoint

    payload = load_checkpoint(resolve_checkpoint(demo_run), keys=("cfg", "model"))
    cfg_map = dict(payload["cfg"], termination_aux=True)
    cfg = CodonGPTConfig.from_run_config(dict(cfg_map, vocab_size=68))
    torch.manual_seed(train_main.SEED)
    head = params_to_jax(CodonGPT(cfg), cfg)["termination_head"]
    run = workdir / "head_run"
    (run / "checkpoints").mkdir(parents=True)
    save_checkpoint({"model": dict(payload["model"], termination_head=head), "cfg": cfg_map},
                    run / "checkpoints" / "best.npz")
    (run / "itos.txt").write_bytes((demo_run / "itos.txt").read_bytes())
    return run


def plan_microbatches(npz: Path, batch_size: int, limit: int | None = None) -> int:
    """Microbatches a packed split gives ``evaluate_perplexity`` (``limit``:
    the scripts' first ``limit`` windows in order instead)."""
    ds = PackedDataset(str(npz))
    if limit is not None:
        return -(-min(len(ds), limit) // batch_size)
    plan = EpochPlan(ds, batch_size=batch_size, seed=0, epoch=0, shuffle=False)
    return sum(1 for x, _ in plan.microbatches() if x.shape[0])


def phase_diagnoses(demo: dict, data: Path, records: list[dict], workdir: Path,
                    card: str) -> dict:
    """``[diagnoses]`` on phase 33's demo run and the block-512 demo splits:
    ``evals/calibration_metrics.py`` and ``evals/diagnose_context_learning.py``
    at their defaults (the flash forward 10 a microbatch of 32: the
    calibration's first 16, the position pass's first 8, the ablation's
    whole split for each of windows 1, 2, 4, 8 and full); the float32 NLL and
    ECE of the first ``SCORE_CPU_WINDOWS`` validation windows on the card
    against the CPU (TF32 off) within ``SCORE_NLL_RTOL``;
    ``diagnose_termination_probabilities`` (32 cached steps) and
    ``run_decoding_termination_ablation --biases 0,4 --n_samples 2`` (the
    decode kernel at B 1, 10 a step); ``eval_ppl_baselines`` on the train and
    validation splits (host); ``benchmark_zero_shot_mutations`` on a demo
    CDS with a seeded fitness table of ``DMS_VARIANTS`` variants (one
    forward); ``evaluate_termination_head`` on the demo run (no head: the
    skip) and on ``head_run``'s, its confusion matrix covering every
    labelled target of its first 8 microbatches."""
    from genomics_lm_torch.evals.benchmark_zero_shot_mutations import main as dms_cli
    from genomics_lm_torch.evals.calibration_metrics import calibration_report
    from genomics_lm_torch.evals.calibration_metrics import main as calibration_cli
    from genomics_lm_torch.evals.diagnose_context_learning import main as context_cli
    from genomics_lm_torch.evals.diagnose_termination_probabilities import main as probs_cli
    from genomics_lm_torch.evals.eval_ppl_baselines import main as baselines_cli
    from genomics_lm_torch.evals.evaluate_termination_head import main as head_cli
    from genomics_lm_torch.evals.run_decoding_termination_ablation import main as ablation_cli
    from genomics_lm_torch.ops.losses import termination_distance_bucket_labels

    L = train_main.MAIN_TRAIN["n_layer"]
    run, val, train = Path(demo["run_dir"]), data / "val_bs512.npz", data / "train_bs512.npz"
    secs, launches, out = {}, {}, {}

    timed = functools.partial(run_timed, secs, launches)

    for name, cli, argv in (("calibration", calibration_cli, ["--npz", str(val)]),
                            ("context", context_cli, ["--npz", str(val)])):
        timed(name, cli, [str(run), *argv, "--out", str(workdir / f"{name}.json")])
        out[name] = json.loads((workdir / f"{name}.json").read_text())
    want_fwd = {"calibration": L * plan_microbatches(val, 32, 16 * 32),
                "context": L * (plan_microbatches(val, 32, 8 * 32)
                                + 5 * plan_microbatches(val, 32))}

    # float32 (TF32 off) on the card and on the CPU: the first windows' NLL and ECE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with np.load(val) as z:
        subset = workdir / "val_head.npz"
        np.savez(subset, X=z["X"][:SCORE_CPU_WINDOWS], Y=z["Y"][:SCORE_CPU_WINDOWS])
    f32 = {}
    t0 = time.perf_counter()
    payload = load_checkpoint(resolve_checkpoint(run), keys=("cfg", "model"))
    cfg = CodonGPTConfig.from_run_config(dict(payload["cfg"], vocab_size=68)).replace(
        compute_dtype="float32", dropout=0.0)
    for device in ("cuda:0", "cpu"):
        model = params_from_jax(payload["model"], cfg, device).eval()
        cal = calibration_report(model, cfg, subset, 10, 1, SCORE_CPU_WINDOWS)
        f32[device] = {"nll": ppl.evaluate_perplexity(model, cfg, subset,
                                                      batch_size=SCORE_CPU_WINDOWS)["nll"],
                       "ece": cal["ece"], "brier_top1": cal["brier_top1"]}
        del model
    secs["card_vs_cpu"] = time.perf_counter() - t0
    card_cpu = {k: abs(f32["cuda:0"][k] - f32["cpu"][k]) / abs(f32["cpu"][k])
                for k in ("nll", "ece")}

    printed = timed("termination_probabilities", probs_cli,
                    [str(run), "--out", str(workdir / "term_probs.json")])
    out["termination_probabilities"] = json.loads(printed)
    rows = json.loads((workdir / "term_probs.json").read_text())
    timed("termination_ablation", ablation_cli,
          [str(run), "--biases", "0,4", "--n_samples", "2",
           "--out", str(workdir / "term_ablation.json")])
    out["termination_ablation"] = json.loads((workdir / "term_ablation.json").read_text())

    t0 = time.perf_counter()
    baselines = {}
    for split, npz in (("train", train), ("val", val)):
        dest = workdir / f"baselines_{split}.json"
        _run_cli(baselines_cli, ["--train_npz", str(train), "--eval_npz", str(npz),
                                 "--out", str(dest)])
        baselines[split] = json.loads(dest.read_text())
    secs["ppl_baselines"] = time.perf_counter() - t0

    cds = next(r["sequence"] for r in records if 100 <= len(r["sequence"]) // 3 <= 400)
    rng = np.random.default_rng(DMS_VARIANTS)
    table = workdir / "dms.csv"
    with table.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["position", "mutant_codon", "fitness"])
        for _ in range(DMS_VARIANTS):
            writer.writerow([int(rng.integers(0, len(cds) // 3)),
                             "".join(rng.choice(list("ACGT"), 3)), float(rng.normal())])
    fasta = workdir / "wild_type.fasta"
    fasta.write_text(f">wild_type\n{cds}\n")
    timed("dms", dms_cli, [str(run), "--dna", str(fasta), "--dms_csv", str(table),
                           "--out", str(workdir / "dms.json")])
    out["dms"] = json.loads((workdir / "dms.json").read_text())
    want_fwd["dms"] = L  # one window: the CDS and BOS fit in 512

    skip = json.loads(timed("termination_head_skip", head_cli, [str(run), "--npz", str(val)]))
    t0 = time.perf_counter()
    headed = head_run(run, workdir)
    secs["head_run_written"] = time.perf_counter() - t0
    timed("termination_head", head_cli, [str(headed), "--npz", str(val),
                                         "--out", str(workdir / "term_head.json")])
    out["termination_head"] = json.loads((workdir / "term_head.json").read_text())
    with np.load(val) as z:
        y = torch.from_numpy(z["Y"][: 8 * 32].astype(np.int64))
    labelled = int((termination_distance_bucket_labels(y, STOP_IDS) != -100).sum())
    want_fwd["termination_head"] = L * plan_microbatches(val, 32, 8 * 32)

    row = dict(reports=out, rows_termination_probabilities=len(rows), skip=skip,
               baselines=baselines, card_vs_cpu_f32=dict(f32, rel_err=card_cpu,
                                                         tol=SCORE_NLL_RTOL),
               launches=launches, want_flash=want_fwd, labelled_targets=labelled,
               seconds=secs, card=card)
    log("diagnoses", **row)
    for name, want in want_fwd.items():
        if launches[name]["flash_fwd"] != want:
            raise AssertionError(f"{name} flash launches {launches[name]}, want {want}")
    for name in ("termination_probabilities", "termination_ablation"):
        got = launches[name]
        if got["decode_steps"] == 0 or got["decode_attention"] != L * got["decode_steps"]:
            raise AssertionError(f"{name} decode launches {got}")
    if max(card_cpu.values()) > SCORE_NLL_RTOL:
        raise AssertionError(f"float32 card against CPU: {f32}")
    if (len(rows) != 32 or "skipped" not in skip
            or out["termination_head"]["tokens"] != labelled or not labelled
            or out["dms"]["n_variants"] != DMS_VARIANTS or out["dms"]["skipped"]
            or not np.isfinite(out["dms"]["spearman_rho"])
            or out["calibration"]["tokens"] == 0 or not np.isfinite(out["calibration"]["ece"])
            or set(out["context"]["window_ablation"]) != {"1", "2", "4", "8", "full"}
            or [r["stop_bias"] for r in out["termination_ablation"]] != [0.0, 4.0]
            or not all(b["eval_tokens"] > 0 for b in baselines.values())):
        raise AssertionError(f"the diagnoses' reports: {row}")
    return {"flash": sum(v["flash_fwd"] for v in launches.values()),
            "decode": sum(v["decode_attention"] for v in launches.values())}


# --- phase 56: the representation benchmarks ---------------------------------------

REPR_GENES = 4_300  # E. coli K-12 MG1655's CDS count (NCBI RefSeq NC_000913.3), as [genbank]
# essential = the 7% of genes with the highest GC3: ~300, the Keio collection's count of
# essential genes among E. coli's 4,300 (Baba et al. 2006); GC3 is linear in the codon
# frequencies, so the frequency baselines can find it
REPR_ESSENTIAL_SHARE = 0.07
# benchmark_essentiality_baselines at 3 of its default 5 folds, a cut for time: its booster's
# 5 folds of 3,440 genes took 22.7 s of the card machine's host (one H100 machine)
REPR_BASELINE_FOLDS = 3
REPR_CLUSTERS = 430  # the seeded cluster column of the grouped selection: ~10 genes a cluster
REPR_POOLINGS = ("mean_nonpad", "eos")  # the grouped selection's two candidates
REPR_CPU_GENES = 64  # genes whose float32 embeddings run on both devices
REPR_B1_T = (25, 33, 49)  # the probes' batch-1 forwards: BOS + 24, 32 and 48 codons
# benchmark_essentiality_baselines' codon_freq_logreg is LogisticRegression(max_iter=2000) at
# C 1 on the raw frequencies: on this gene set sklearn 1.9.0 (the JAX script, on the CPU)
# calls no gene essential in any of the 3 folds, mean F1 0.0 (accuracy 0.93, the negative
# share), and the port's estimators give the same report bit for bit
# (tests/test_torch_estimators.py); the floor is that F1
CODON_LOGREG_F1_FLOOR = 0.0
CODON_LOGREG_F1_FLOOR_REASON = (
    "sklearn 1.9.0's mean F1 of the script's codon_freq_logreg on this gene set (the 4,300 "
    "demo genes of seed 1337, the top 7% by GC3 essential, 3 folds of seed 0) is 0.0: at C 1 "
    "the L2 penalty outweighs frequencies of order 1/61, and the unweighted fit calls every "
    "gene non-essential; a lower F1 is impossible, so the check is that the F1 is finite and "
    "the report is the one sklearn gives")
# sklearn 1.9.0's reports of the two codon-frequency columns on that gene set (the JAX script
# without a run, on the CPU; 3 folds), held to the port's when the gene set's bytes match
CODON_FREQ_SKLEARN = {
    "sha256": "517ce3ccc9ff2e59fe264d3d1fe532fbb87a75d14aa476a9bd44cecfd68bc522",
    "codon_freq_logreg": {"mean_f1": 0.0, "std_f1": 0.0, "mean_accuracy": 0.9300001005715383},
    "codon_freq_gbdt": {"mean_f1": 0.2905463951477016, "std_f1": 0.046644851538757866,
                        "mean_accuracy": 0.9413946936509836},
}


def gc3(dna: str) -> float:
    """The G/C share at the third position of the codons after ATG."""
    thirds = dna[5::3]
    return sum(c in "GC" for c in thirds) / max(len(thirds), 1)


def representation_run(demo_run: Path, workdir: Path) -> Path:
    """A run directory for the worker: the demo run's files linked, its own
    ``scores`` and ``tables`` (the CLIs write there while later phases read
    the demo run)."""
    run = workdir / "run"
    run.mkdir()
    for entry in demo_run.iterdir():
        if entry.name not in ("scores", "tables"):
            (run / entry.name).symlink_to(entry.resolve())
    return run


def start_representation(demo: dict, data: Path, records_tsv: Path, workdir: Path) -> dict:
    """Start phase 56's CLIs in a worker process of their own
    (``representation_worker``, one host thread), beside phases 38-55: they
    spend most of their time on the host (the folds' fits) and need the card
    only for their forwards. ``phase_representation`` joins it."""
    spec = {"run_dir": str(representation_run(Path(demo["run_dir"]), workdir)),
            "val_npz": str(data / "val_bs512.npz"), "records_tsv": str(records_tsv),
            "workdir": str(workdir)}
    return dict(start_worker("representation_worker", spec, workdir),
                val_npz=spec["val_npz"])


def start_worker(fn_name: str, spec: dict, workdir: Path) -> dict:
    """``chip_smoke.<fn_name>(spec.json)`` in a process of its own with one
    host thread, its output piped; killed at exit if a later phase fails
    before the worker is joined."""
    (workdir / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import sys, chip_smoke; sys.exit(chip_smoke.{fn_name}("
         "sys.argv[1]))", str(workdir / "spec.json")],
        cwd=str(Path(__file__).resolve().parent), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    worker = {"proc": proc, "workdir": workdir, "t0": time.perf_counter()}
    atexit.register(stop_worker, worker)
    return worker


def stop_worker(worker: dict) -> None:
    if worker["proc"].poll() is None:
        worker["proc"].kill()
    worker["proc"].communicate()


def representation_worker(spec_path: str) -> int:
    """Phase 56's CLIs on the card, each with the flash and decode kernels'
    launches reset just before it and read just after: the 4,300-gene set
    (``data/demo_corpus.py``, labelled by GC3), ``benchmark_gene_essentiality``
    and ``benchmark_essentiality_baselines`` with the demo run, the run's
    embeddings in two poolings for ``select_grouped_representation``, the three
    structural probes, ``probe_next_token --npz``, the float32 embeddings of
    64 genes on the card and the CPU, and the five host tools on the demo
    records. Writes ``result.json`` beside the spec."""
    from genomics_lm_torch.data.demo_corpus import main as demo_corpus
    from genomics_lm_torch.data.leakage import translate_cds
    from genomics_lm_torch.evals import hist_gbdt
    from genomics_lm_torch.evals.audit_structural_motifs import main as audit_cli
    from genomics_lm_torch.evals.benchmark_essentiality_baselines import main as baselines_cli
    from genomics_lm_torch.evals.benchmark_gene_essentiality import main as essentiality_cli
    from genomics_lm_torch.evals.disorder_heuristics import main as disorder_cli
    from genomics_lm_torch.evals.eval_shape_baselines import main as shape_cli
    from genomics_lm_torch.evals.filter_cds_by_pdb import main as pdb_cli
    from genomics_lm_torch.evals.generate_probe_labels import main as labels_cli
    from genomics_lm_torch.evals.probe_next_token import main as next_token_cli
    from genomics_lm_torch.evals.probe_structural_awareness import main as awareness_cli
    from genomics_lm_torch.evals.probe_structural_regression import main as regression_cli
    from genomics_lm_torch.evals.select_grouped_representation import main as select_cli
    from genomics_lm_torch.evals.ss_propensity import main as ss_cli
    from genomics_lm_torch.evals.termination_motifs import synthetic_hairpin

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    work, run, val = Path(spec["workdir"]), spec["run_dir"], spec["val_npz"]
    device = spec.get("device", "cuda")
    secs, launches, reports = {}, {}, {}

    timed = functools.partial(run_timed, secs, launches)

    t0 = time.perf_counter()
    corpus = work / "genes.tsv"
    with contextlib.redirect_stdout(io.StringIO()):
        demo_corpus(["--out", str(corpus), "--genes", str(spec.get("genes", REPR_GENES)),
                     "--seed", str(DEMO_SEED)])
    with corpus.open() as f:
        genes = list(csv.DictReader(f, delimiter="\t"))
    score = np.asarray([gc3(g["sequence"]) for g in genes])
    essential = np.zeros(len(genes), int)
    essential[np.argsort(-score, kind="stable")[:round(REPR_ESSENTIAL_SHARE * len(genes))]] = 1
    genes_csv = work / "genes.csv"
    with genes_csv.open("w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["id", "sequence", "essential"])
        writer.writerows([g["source_id"], g["sequence"], int(e)]
                         for g, e in zip(genes, essential))
    secs["gene_set"] = time.perf_counter() - t0
    sha = hashlib.sha256(genes_csv.read_bytes()).hexdigest()

    timed("essentiality", essentiality_cli, [run, "--genes_csv", str(genes_csv), "--out",
                                             str(work / "essentiality.json"), "--device", device])
    reports["essentiality"] = json.loads((work / "essentiality.json").read_text())
    fit, gbdt = hist_gbdt.HistGradientBoostingClassifier.fit, []

    def timed_fit(self, X, y):
        t = time.perf_counter()
        out = fit(self, X, y)
        gbdt.append(time.perf_counter() - t)
        return out

    hist_gbdt.HistGradientBoostingClassifier.fit = timed_fit
    try:
        timed("baselines", baselines_cli, [run, "--genes_csv", str(genes_csv), "--folds",
                                           str(REPR_BASELINE_FOLDS), "--out",
                                           str(work / "baselines.json"), "--device", device])
    finally:
        hist_gbdt.HistGradientBoostingClassifier.fit = fit
    reports["baselines"] = json.loads((work / "baselines.json").read_text())

    # the run's embeddings in two poolings, and a seeded cluster column, for the selection
    model, cfg, _, _ = load_codon_model(run, device=device)
    cfg = cfg.replace(dropout=0.0)
    rows = np.stack([emb_lib.ids_from_dna(g["sequence"], cfg.block_size) for g in genes])
    ids = np.asarray([g["source_id"] for g in genes])
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    packs = []
    for mode in REPR_POOLINGS:
        X = emb_lib.extract_embeddings(model, cfg, rows, mode=mode)
        packs.append(work / f"emb_{mode}.npz")
        np.savez(packs[-1], ids=ids, X=X, pooling=np.asarray(mode))
    secs["pooled_embeddings"] = time.perf_counter() - t0
    launches["pooled_embeddings"] = {"flash_fwd": fa.flash_fwd.launches}
    rng = np.random.default_rng(DEMO_SEED)
    with (work / "labels.csv").open("w") as f:
        f.write("id,label\n" + "".join(f"{i},{e}\n" for i, e in zip(ids, essential)))
    with (work / "groups.csv").open("w") as f:
        f.write("id,protein_cluster\n" + "".join(
            f"{i},c{int(c)}\n" for i, c in zip(ids, rng.integers(0, REPR_CLUSTERS, len(ids)))))
    timed("select", select_cli, ["--embeddings", *map(str, packs), "--labels",
                                 str(work / "labels.csv"), "--groups", str(work / "groups.csv"),
                                 "--output", str(work / "selection.json")])
    reports["select"] = json.loads((work / "selection.json").read_text())

    # float32 (TF32 off) embeddings of the first genes on the card and the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = cfg.replace(compute_dtype="float32")
    card_f32 = emb_lib.extract_embeddings(model, f32, rows[:REPR_CPU_GENES])
    cpu_f32 = emb_lib.extract_embeddings(copy.deepcopy(model).cpu(), f32, rows[:REPR_CPU_GENES])
    f32_err = float(np.abs(card_f32 - cpu_f32).max())
    del model

    for name, cli in (("awareness", awareness_cli), ("regression", regression_cli),
                      ("shape_baselines", shape_cli)):
        timed(name, cli, [run, "--out", str(work / f"{name}.json"), "--device", device])
        reports[name] = json.loads((work / f"{name}.json").read_text())
    reports["next_token"] = json.loads(timed("next_token", next_token_cli,
                                             [run, "--npz", val, "--device", device]))

    # the host tools on the demo records
    with open(spec["records_tsv"]) as f:
        cds = [r["sequence"] for r in csv.DictReader(f, delimiter="\t")]
    (work / "cds.txt").write_text("\n".join(cds) + "\n")
    with (work / "uniprot.tsv").open("w") as f:
        f.write("Entry\tSequence\tKeywords\tCross-reference (PDB)\n")
        for i, dna in enumerate(cds):
            if i % 10 in (0, 3):  # every 10th with the keyword, every 10th + 3 with a PDB id
                f.write(f"P{i}\t{translate_cds(dna)}\t{'3D-structure' if i % 10 == 0 else ''}"
                        f"\t{'1ABC;' if i % 10 == 3 else ''}\n")
    hairpin = synthetic_hairpin()
    (work / "motifs.json").write_text(json.dumps({"clusters": {
        "0": {"consensus": " ".join(hairpin[i:i + 3] for i in range(0, len(hairpin) - 2, 3)),
              "size": 12},
        "1": {"consensus": "ATG TTT TTT GCA", "size": 30},
        "2": {"consensus": "GCA GAA AAC", "size": 40}}}))
    timed("probe_labels", labels_cli, [run])
    for name, cli, argv in (
            ("ss_propensity", ss_cli, ["--dna", str(work / "cds.txt"), "--out",
                                       str(work / "ss.json")]),
            ("disorder", disorder_cli, ["--dna", str(work / "cds.txt"), "--out",
                                        str(work / "disorder.json")]),
            ("pdb_filter", pdb_cli, ["--cds", str(work / "cds.txt"), "--uniprot_tsv",
                                     str(work / "uniprot.tsv"), "--out",
                                     str(work / "structured.txt")]),
            ("motif_audit", audit_cli, [run, "--motifs_json", str(work / "motifs.json")])):
        reports[name] = json.loads(timed(name, cli, argv))
    with (Path(run) / "probe_labels.csv").open() as f:
        reports["probe_labels"] = {"rows": sum(1 for _ in csv.DictReader(f))}

    (work / "result.json").write_text(json.dumps({
        "reports": reports, "launches": launches, "seconds": secs, "gbdt_fit_seconds": gbdt,
        "genes": len(genes), "essential": int(essential.sum()), "genes_sha256": sha,
        "f32_card_vs_cpu_max_abs": f32_err, "cds": len(cds),
        "structured_rows": sum(1 for i in range(len(cds)) if i % 10 in (0, 3)),
        "block": cfg.block_size, "n_layer": cfg.n_layer}))
    return 0


def phase_representation(worker: dict, card: str, peak_bw, peak_ops) -> dict:
    """``[representation]``: joins the worker started before phase 38 and holds
    its reports and launches to the paths: the flash forward 10 x ⌈4,300 /
    64⌉ for each essentiality CLI and for each pooling of the selection, 10 x
    48, 10 x 64 and 10 x 64 for the three probes (batch 1), 10 a microbatch
    of 32 over the first 256 validation windows for ``probe_next_token``, and
    the decode kernel 10 a cached step (its four default prefixes take one:
    ``ATG-AAA`` extends ``ATG``; the others are prefilled on the plain path);
    every F1, R² and ρ finite; ``codon_freq_logreg`` at or over
    ``CODON_LOGREG_F1_FLOOR``; the float32 embeddings within ``EMBED_F32_ATOL``
    of the CPU; the hairpin consensus flagged. Then the flash forward at the
    probes' batch-1 shapes against its plain version, timed."""
    t0 = time.perf_counter()
    log_text, _ = worker["proc"].communicate(timeout=900)
    waited = time.perf_counter() - t0
    if worker["proc"].returncode != 0:
        raise AssertionError(f"the representation worker exited {worker['proc'].returncode}: "
                             f"{log_text[-3000:]}")
    res = json.loads((worker["workdir"] / "result.json").read_text())
    L, reports, launches = res["n_layer"], res["reports"], res["launches"]
    batches = -(-res["genes"] // 64)
    with np.load(worker["val_npz"]) as z:
        val_windows = int(z["X"].shape[0])
    want_flash = {"essentiality": L * batches, "baselines": L * batches,
                  "pooled_embeddings": len(REPR_POOLINGS) * L * batches,
                  "awareness": L * 48, "regression": L * 64, "shape_baselines": L * 64,
                  "next_token": L * -(-min(val_windows, 8 * 32) // 32)}
    gbdt_s = sum(res["gbdt_fit_seconds"])
    base = reports["baselines"]
    f1s = ([reports["essentiality"]["f1_mean"]] + [c["mean_f1"] for c in base.values()]
           + [c[f"mean_{reports['select']['primary_metric']}"]
              for c in reports["select"]["candidates"]])
    r2s = ([v["r2"] for v in reports["awareness"]["params"].values() if v["r2"] is not None]
           + [v[k] for v in reports["regression"].values() for k in ("r2", "spearman_rho")]
           + [v[k] for v in reports["shape_baselines"].values()
              for k in ("avg_r2", "avg_spearman")])
    sklearn_match = None
    if res["genes_sha256"] == CODON_FREQ_SKLEARN["sha256"]:
        sklearn_match = all(abs(base[c][k] - CODON_FREQ_SKLEARN[c][k]) <= 1e-9
                            for c in ("codon_freq_logreg", "codon_freq_gbdt")
                            for k in ("mean_f1", "std_f1", "mean_accuracy"))
    audit = reports["motif_audit"]
    hairpin_flagged = any(r["cluster"] == "0" and r["hairpin_score"] >= audit["hairpin_threshold"]
                          for r in audit["top_structural"])
    gen = torch.Generator(device="cuda").manual_seed(56)
    timed = {f"b1_t{T}": check_flash_forward(gen, "representation_kernel", f"b1_t{T}", 1, T,
                                             None, peak_bw, peak_ops)
             for T in REPR_B1_T}
    row = dict(genes=res["genes"], essential=res["essential"], genes_sha256=res["genes_sha256"],
               reports=reports, launches=launches, want_flash=want_flash,
               seconds=res["seconds"], gbdt_fit_seconds=res["gbdt_fit_seconds"],
               gbdt_folds_seconds=gbdt_s, baseline_folds=REPR_BASELINE_FOLDS,
               codon_logreg_f1_floor=CODON_LOGREG_F1_FLOOR,
               codon_logreg_f1_floor_reason=CODON_LOGREG_F1_FLOOR_REASON,
               codon_freq_equals_sklearn=sklearn_match,
               f32_card_vs_cpu_max_abs=res["f32_card_vs_cpu_max_abs"], f32_atol=EMBED_F32_ATOL,
               hairpin_flagged=hairpin_flagged, worker_seconds=time.perf_counter() - worker["t0"],
               waited_s=waited, flash_b1=timed, card=card)
    log("representation", **row)
    for name, want in want_flash.items():
        if launches[name]["flash_fwd"] != want:
            raise AssertionError(f"{name} flash launches {launches[name]}, want {want}")
    nt = launches["next_token"]
    if nt["decode_steps"] != 1 or nt["decode_attention"] != L * nt["decode_steps"]:
        raise AssertionError(f"probe_next_token decode launches {nt}")
    if (not all(np.isfinite(f1s)) or not all(np.isfinite(r2s))
            or not base["codon_freq_logreg"]["mean_f1"] >= CODON_LOGREG_F1_FLOOR
            or sklearn_match is False
            or res["f32_card_vs_cpu_max_abs"] > EMBED_F32_ATOL or not hairpin_flagged
            or reports["essentiality"]["folds"] != 5 or res["essential"] != 301
            or len(reports["next_token"]["prefixes"]) != 20
            or reports["next_token"]["accuracy"]["tokens"] == 0
            or reports["select"]["n_ids"] != res["genes"]
            or reports["pdb_filter"]["kept"] != res["structured_rows"]
            or reports["probe_labels"]["rows"] != 68
            or reports["ss_propensity"]["sequences"] != res["cds"]
            or reports["disorder"]["sequences"] != res["cds"]):
        raise AssertionError(f"the representation reports: {row}")
    flash = sum(launches[k]["flash_fwd"] for k in want_flash)
    return {"flash": flash, "decode": nt["decode_attention"], "flash_timed": timed}


CLS_TRAIN, CLS_TEST = 480, 240  # demo records in the classifiers' train and test packs
CLS_KINDS = ("probe_logreg", "probe_svm", "kmer_logreg", "kmer_svm")
CLS_SS_GENES = 64  # genes whose per-token hidden states feed probe_ss_linear
CLS_BATCH = 64  # extract_embeddings' default batch
MOTIF_HDBSCAN_ROWS, MOTIF_HDBSCAN_PCA = 2_000, 16
# A window may take another centre when the float64 relabelling and the fit's
# float32 E-step (sklearn's ||c||^2 - 2 x.c, one float32 GEMM over the features,
# on the centred data) see two centres within float32 rounding of each other:
# the GEMM's error is below n_features x 2^-24 x (|x|^2 + |c|^2) per distance,
# and a gap under four times that counts as a tie; a window off by more fails.
MOTIF_TIE_FACTOR = 4 * 2.0**-24


def start_classifiers(demo: dict, data: Path, records_tsv: Path, workdir: Path) -> dict:
    """Start the motif clustering and the classifier CLIs in a worker process
    of their own (``classifiers_worker``, one host thread), beside phases
    38-55: the clustering's seconds are host seconds. ``phase_classifiers``
    joins it."""
    spec = {"run_dir": str(demo["run_dir"]), "train_npz": str(data / "train_bs512.npz"),
            "manifest": str(data / "manifest.json"), "records_tsv": str(records_tsv),
            "workdir": str(workdir)}
    return start_worker("classifiers_worker", spec, workdir)


@contextlib.contextmanager
def recorded_predictions(calls: list):
    """Each bootstrap (test) report's true and predicted classes while the
    block runs: the CLIs import ``compute_metrics`` from its module at call
    time."""
    from genomics_lm_torch.evals import metrics as metrics_mod

    fn = metrics_mod.compute_metrics

    def recording(y_true, y_pred, y_proba=None, bootstrap=False, **kw):
        if bootstrap:
            calls.append({"true": sorted(np.unique(y_true).tolist()),
                          "predicted": sorted(np.unique(y_pred).tolist())})
        return fn(y_true, y_pred, y_proba, bootstrap=bootstrap, **kw)

    metrics_mod.compute_metrics = recording
    try:
        yield calls
    finally:
        metrics_mod.compute_metrics = fn


def motif_relabel(emb: np.ndarray, km) -> dict:
    """Every window relabelled against the fit's final centres in float64:
    the windows whose label differs, and how many of them are float32 ties."""
    centers = km.cluster_centers_.astype(np.float64)
    c2 = (centers**2).sum(axis=1)
    differ = ties = 0
    for start in range(0, len(emb), 8192):
        x = emb[start:start + 8192].astype(np.float64)
        x2 = (x**2).sum(axis=1)
        d = x2[:, None] - 2 * x @ centers.T + c2[None, :]
        best, got = np.argmin(d, axis=1), km.labels_[start:start + 8192]
        rows = np.flatnonzero(best != got)
        gap = d[rows, got[rows]] - d[rows, best[rows]]
        tol = MOTIF_TIE_FACTOR * emb.shape[1] * (x2[rows] + c2.max())
        differ += len(rows)
        ties += int(np.sum(gap <= tol))
    return {"relabel_differ": differ, "relabel_ties": ties}


def classifiers_worker(spec_path: str) -> int:
    """``mine_motifs`` at its defaults on the demo run (its KMeans captured for
    the checks), an HDBSCAN fit on a slice of its windows, then the classifier
    CLIs on GC3-tertile labels of the demo records: ``extract_embeddings``
    packs, ``train_classifier`` (four kinds), ``eval_classifier`` on their
    pickles, ``probe_linear`` (logreg, svm), ``benchmark_xgboost_dna`` and
    ``probe_ss_linear`` on per-token hidden states; each CLI with the flash and
    decode kernels' launches reset just before it and read just after. Writes
    ``result.json`` beside the spec."""
    import pickle

    from genomics_lm_torch.data.leakage import translate_cds
    from genomics_lm_torch.evals import motifs as motifs_mod
    from genomics_lm_torch.evals import probes
    from genomics_lm_torch.evals.benchmark_xgboost_dna import main as xgb_cli
    from genomics_lm_torch.evals.eval_classifier import main as eval_cli
    from genomics_lm_torch.evals.mine_motifs import main as mine_cli
    from genomics_lm_torch.evals.probe_linear import main as linear_cli
    from genomics_lm_torch.evals.probe_ss_linear import LABELS as SS_LABELS
    from genomics_lm_torch.evals.probe_ss_linear import main as ss_cli
    from genomics_lm_torch.evals.ss_propensity import classify
    from genomics_lm_torch.evals.train_classifier import main as train_cls_cli

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    work, run = Path(spec["workdir"]), spec["run_dir"]
    device = spec.get("device", "cuda")
    secs, launches, reports, predictions = {}, {}, {}, {}

    timed = functools.partial(run_timed, secs, launches, predictions=predictions)

    # mine_motifs at its defaults; its clusterer and embeddings kept for the checks
    fits, fit_predict = [], motifs_mod.MotifClusterer.fit_predict

    def recorded_fit(self, embeddings):
        t = time.perf_counter()
        labels = fit_predict(self, embeddings)
        fits.append({"clusterer": self, "emb": embeddings, "seconds": time.perf_counter() - t})
        return labels

    motifs_mod.MotifClusterer.fit_predict = recorded_fit
    try:
        timed("mine_motifs", mine_cli, [run, "--npz", spec["train_npz"], "--out",
                                        str(work / "motifs.json"), "--device", device])
    finally:
        motifs_mod.MotifClusterer.fit_predict = fit_predict
    mined = json.loads((work / "motifs.json").read_text())
    km, emb = fits[0]["clusterer"].model, fits[0]["emb"]
    sizes = [c["size"] for c in mined["clusters"].values()]
    motif = dict(n_windows=mined["n_windows"], n_clusters=mined["n_clusters"],
                 clusters_reported=len(sizes), smallest=min(sizes), sizes_sum=sum(sizes),
                 n_iter=km.n_iter_, inertia=km.inertia_, init_inertia=km.init_inertia_,
                 fit_seconds=fits[0]["seconds"], embedding_shape=list(emb.shape),
                 clusters_with_known_motif=sum(bool(c["known_motifs"])
                                               for c in mined["clusters"].values()),
                 **motif_relabel(emb, km))
    t0 = time.perf_counter()
    dense = motifs_mod.MotifClusterer(method="hdbscan", pca_components=MOTIF_HDBSCAN_PCA)
    dense_labels = dense.fit_predict(emb[:MOTIF_HDBSCAN_ROWS])
    counts = np.unique(dense_labels[dense_labels >= 0], return_counts=True)[1]
    comps = dense.pca.components_.astype(np.float64)
    hdbscan = dict(rows=MOTIF_HDBSCAN_ROWS, pca_components=MOTIF_HDBSCAN_PCA,
                   pca_solver=dense.pca.svd_solver_, clusters=len(counts),
                   noise=int(np.sum(dense_labels == -1)),
                   min_cluster_size=dense.model.min_cluster_size,
                   smallest=int(counts.min()) if len(counts) else None,
                   orthonormal_err=float(np.abs(comps @ comps.T - np.eye(len(comps))).max()),
                   seconds=time.perf_counter() - t0)
    del fits, emb

    # GC3-tertile labels of the demo records, the packs and the label files
    with open(spec["records_tsv"]) as f:
        genes = list(csv.DictReader(f, delimiter="\t"))[:CLS_TRAIN + CLS_TEST]
    gc = np.asarray([gc3(g["sequence"]) for g in genes])
    labels = np.searchsorted(np.quantile(gc, [1 / 3, 2 / 3]), gc, side="right")
    split = {"train": slice(0, CLS_TRAIN), "test": slice(CLS_TRAIN, CLS_TRAIN + CLS_TEST)}
    with (work / "labels.csv").open("w") as f:
        f.write("id,label\n" + "".join(f"{g['source_id']},{y}\n" for g, y in zip(genes, labels)))
    for name, rows in split.items():
        part = list(zip(genes[rows], labels[rows]))
        (work / f"{name}.fasta").write_text(
            "".join(f">{g['source_id']}\n{g['sequence']}\n" for g, _ in part))
        with (work / f"{name}.csv").open("w") as f:
            f.write("id,sequence,label\n" + "".join(f"{g['source_id']},{g['sequence']},{y}\n"
                                                    for g, y in part))
        timed(f"extract_{name}", extract_cli,
              [run, "--input", str(work / f"{name}.fasta"), "--out", str(work / f"{name}.npz"),
               "--dataset_manifest", spec["manifest"], "--device", device])
        with np.load(work / f"{name}.npz") as z:  # the kmer kinds read the sequences too
            np.savez(work / f"{name}_seq.npz", X=z["X"], ids=z["ids"],
                     sequences=np.asarray([g["sequence"] for g, _ in part]))
    labels_csv = str(work / "labels.csv")

    for kind in CLS_KINDS:
        kmer = kind.startswith("kmer")
        pack = "{}_seq.npz" if kmer else "{}.npz"
        config = work / f"{kind}.yaml"
        config.write_text(json.dumps(dict(
            kind=kind, protocol="std", train_npz=str(work / pack.format("train")),
            test_npz=str(work / pack.format("test")), train_labels=labels_csv,
            test_labels=labels_csv, require_verified_provenance=not kmer, k=3)))
        timed(f"train_{kind}", train_cls_cli, ["--config", str(config), "--out_dir",
                                               str(work / kind), "--device", device])
        reports[f"train_{kind}"] = json.loads((work / kind / "metrics.json").read_text())
    vectorizer = work / "vectorizer.pkl"
    with vectorizer.open("wb") as f:  # the kmer kinds' vectorizer, fitted on the train genes
        pickle.dump(probes._tfidf(3, True).fit([g["sequence"] for g in genes[split["train"]]]),
                    f)
    for kind in CLS_KINDS:
        features = (["--kind", "kmer", "--vectorizer", str(vectorizer), "--seqs",
                     str(work / "test.csv")] if kind.startswith("kmer")
                    else ["--kind", "probe", "--embeddings", str(work / "test.npz")])
        timed(f"eval_{kind}", eval_cli, ["--model", str(work / kind / "model.pkl"),
                                         "--labels", labels_csv, "--out",
                                         str(work / f"eval_{kind}"), *features])
        reports[f"eval_{kind}"] = json.loads((work / f"eval_{kind}" / "metrics.json").read_text())
    for kind in ("logreg", "svm"):
        timed(f"probe_linear_{kind}", linear_cli,
              ["--train_npz", str(work / "train.npz"), "--test_npz", str(work / "test.npz"),
               "--train_labels", labels_csv, "--test_labels", labels_csv, "--kind", kind,
               "--out", str(work / f"linear_{kind}.json")])
        reports[f"probe_linear_{kind}"] = json.loads((work / f"linear_{kind}.json").read_text())
    timed("benchmark_xgboost_dna", xgb_cli, ["--train_csv", str(work / "train.csv"),
                                             "--test_csv", str(work / "test.csv"),
                                             "--out", str(work / "xgboost_dna.json")])
    reports["benchmark_xgboost_dna"] = json.loads((work / "xgboost_dna.json").read_text())

    # per-token hidden states of the first train genes, H/E/C from each codon's residue
    model, cfg, _, _ = load_codon_model(run, device=device)
    cfg = cfg.replace(dropout=0.0)
    ss_genes = genes[:CLS_SS_GENES]
    rows = np.stack([emb_lib.ids_from_dna(g["sequence"], cfg.block_size) for g in ss_genes])
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        states = codon_gpt_mod.hidden_states(model, cfg, torch.as_tensor(
            rows, dtype=torch.long, device=device))
        H = dict(states)["final"].float().cpu().numpy()
    secs["ss_states"] = time.perf_counter() - t0
    launches["ss_states"] = {"flash_fwd": fa.flash_fwd.launches, "decode_attention": 0}
    del model, states
    Y = np.zeros(rows.shape, np.int64)
    M = np.zeros(rows.shape, np.int64)
    for n, g in enumerate(ss_genes):
        classes = classify(translate_cds(g["sequence"]))[:cfg.block_size - 1]
        Y[n, 1:1 + len(classes)] = [SS_LABELS.index(c) for c in classes]
        M[n, 1:1 + len(classes)] = 1
    np.savez(work / "ss_tokens.npz", H=H, Y=Y, M=M)
    timed("probe_ss_linear", ss_cli, ["--emb_npz", str(work / "ss_tokens.npz"), "--out_dir",
                                      str(work / "ss_linear")])
    reports["probe_ss_linear"] = json.loads((work / "ss_linear" / "metrics.json").read_text())
    cm = np.asarray(reports["probe_ss_linear"]["confusion"])
    predictions["probe_ss_linear"] = {
        "true": [i for i in range(len(SS_LABELS)) if cm[i].sum()],
        "predicted": [i for i in range(len(SS_LABELS)) if cm[:, i].sum()]}

    (work / "result.json").write_text(json.dumps({
        "motifs": motif, "hdbscan": hdbscan, "reports": reports, "launches": launches,
        "seconds": secs, "predictions": predictions, "n_layer": cfg.n_layer,
        "genes": {"train": CLS_TRAIN, "test": CLS_TEST, "ss": CLS_SS_GENES,
                  "ss_tokens": int(M.sum()), "labels": np.bincount(labels).tolist()}}))
    return 0


def _finite_metrics(report: dict) -> bool:
    return all(np.isfinite(v) for k, v in report.items()
               if k.split("_ci_")[0] in ("accuracy", "balanced_accuracy", "macro_f1", "auroc",
                                          "macro_auprc"))


def phase_classifiers(worker: dict, card: str) -> dict:
    """``[motifs_clustering]`` and ``[classifiers]``: joins the worker started
    before phase 38. The motif CLI's 100 clusters all non-empty, their sizes
    summing to its windows, the fit's inertia at most its k-means++ start's,
    every window's float64 relabelling equal to the fit's labels but for
    float32 ties (counted), the flash forward n_layer times; the HDBSCAN
    slice's clusters each of at least ``min_cluster_size`` windows and the
    PCA's components orthonormal within 1e-5. Each classifier CLI's flash
    launches as its path implies (10 a batch of 64 genes for the packs, 10
    for the per-token states' one batch, none for the host fits), every
    report finite, each ``eval_classifier`` report equal to its
    ``train_classifier`` test report on that report's keys, and each class
    predicted or stated as not."""
    t0 = time.perf_counter()
    log_text, _ = worker["proc"].communicate(timeout=900)
    waited = time.perf_counter() - t0
    if worker["proc"].returncode != 0:
        raise AssertionError(f"the classifiers worker exited {worker['proc'].returncode}: "
                             f"{log_text[-3000:]}")
    res = json.loads((worker["workdir"] / "result.json").read_text())
    L, launches, reports = res["n_layer"], res["launches"], res["reports"]
    motif, dense = res["motifs"], res["hdbscan"]
    log("motifs_clustering", **motif, hdbscan=dense, cli_seconds=res["seconds"]["mine_motifs"],
        flash_fwd_launches=launches["mine_motifs"]["flash_fwd"], want_launches=L,
        tie_factor=MOTIF_TIE_FACTOR, card=card)
    if (motif["n_clusters"] != 100 or motif["clusters_reported"] != 100
            or motif["smallest"] < 1 or motif["sizes_sum"] != motif["n_windows"]
            or not motif["inertia"] <= motif["init_inertia"]
            or motif["relabel_differ"] != motif["relabel_ties"]
            or launches["mine_motifs"]["flash_fwd"] != L
            or dense["smallest"] is None or dense["smallest"] < dense["min_cluster_size"]
            or dense["orthonormal_err"] > 1e-5):
        raise AssertionError(f"motif clustering: {motif} {dense}")
    want_flash = {name: 0 for name in launches}
    want_flash.update(mine_motifs=L, ss_states=L,
                      extract_train=L * -(-res["genes"]["train"] // CLS_BATCH),
                      extract_test=L * -(-res["genes"]["test"] // CLS_BATCH))
    classes = list(range(len(res["genes"]["labels"])))
    not_predicted = {name: sorted(set(classes if name != "probe_ss_linear" else p["true"])
                                  - set(p["predicted"]))
                     for name, p in res["predictions"].items()}
    test_reports = {name: r.get("test_metrics", r) for name, r in reports.items()
                    if name != "probe_ss_linear"}
    # train_classifier scores a probe SVM without its decision values (the JAX
    # CLI's try), so that report lacks the ranking pair eval_classifier adds
    same_eval = {kind: {k: reports[f"eval_{kind}"].get(k) for k in want} == want
                 for kind in CLS_KINDS
                 for want in [reports[f"train_{kind}"]["test_metrics"]]}
    ss = reports["probe_ss_linear"]
    row = dict(genes=res["genes"], launches=launches, want_flash=want_flash,
               seconds=res["seconds"], eval_reproduces_train=same_eval,
               not_predicted=not_predicted,
               accuracy={name: r["accuracy"] for name, r in test_reports.items()},
               engine=reports["benchmark_xgboost_dna"]["engine"],
               ss_token_accuracy=ss["token_accuracy"], ss_majority=ss["majority_baseline"],
               ss_tokens=(ss["train_tokens"], ss["test_tokens"]),
               worker_seconds=time.perf_counter() - worker["t0"], waited_s=waited, card=card)
    log("classifiers", **row)
    for name, want in want_flash.items():
        if launches[name]["flash_fwd"] != want or launches[name]["decode_attention"] != 0:
            raise AssertionError(f"{name} launches {launches[name]}, want flash {want}")
    if (not all(same_eval.values()) or not all(map(_finite_metrics, test_reports.values()))
            or not np.isfinite(ss["token_accuracy"])
            or ss["train_tokens"] + ss["test_tokens"] != res["genes"]["ss_tokens"]
            or reports["benchmark_xgboost_dna"]["engine"] != PORT_XGB_ENGINE):
        raise AssertionError(f"the classifier reports: {row}")
    return {"flash": sum(v["flash_fwd"] for v in launches.values())}


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
    stress = phase_decode_stress()
    lap("decode_stress")
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
    with (Path(prepare_dir.name) / "records.tsv").open() as f:
        demo_records = list(csv.DictReader(f, delimiter="\t"))
    phase_native(demo_records, card_line)
    lap("native")
    ingest_dir = tempfile.TemporaryDirectory(prefix="smoke_genbank_")
    gbff = phase_genbank(demo_records, Path(ingest_dir.name), card_line)
    lap("genbank")
    hybrid = phase_hybrid_train(gbff, Path(ingest_dir.name), card_line, peak_bw, peak_ops)
    lap("hybrid_train")
    ingest_dir.cleanup()
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
    # phase 56's worker runs beside the protein phases, which keep the card busy and
    # leave host cores free
    repr_dir = tempfile.TemporaryDirectory(prefix="smoke_repr_")
    repr_worker = start_representation(demo_run, data512, Path(prepare_dir.name) / "records.tsv",
                                       Path(repr_dir.name))
    cls_dir = tempfile.TemporaryDirectory(prefix="smoke_classifiers_")
    cls_worker = start_classifiers(demo_run, data512, Path(prepare_dir.name) / "records.tsv",
                                   Path(cls_dir.name))
    protein_dir = tempfile.TemporaryDirectory(prefix="smoke_protein_")
    critic = phase_protein_critic(Path(protein_dir.name), card_line)
    lap("protein_critic")
    phase_protein_lm(critic, card_line)
    lap("protein_lm")
    ebm = phase_protein_ebm(critic, Path(demo_run["run_dir"]) / "scores" / "design_cuda",
                            card_line)
    lap("protein_ebm")
    # the parallel phases' ranks start now and reach the card during phase 41;
    # their work waits for phase 42 and 49's release
    tp_dir = tempfile.TemporaryDirectory(prefix="smoke_tp_")
    pp_dir = tempfile.TemporaryDirectory(prefix="smoke_pp_")
    launches = []
    try:
        par_prep = prepare_parallel_ranks(card_line, Path(tp_dir.name))
        launches.append(par_prep["launch"])
        pp_prep = prepare_pp_ranks(card_line, Path(pp_dir.name))
        launches.append(pp_prep["launch"])
        lap("parallel_prepare")
        guided = phase_critic_guided(demo_run, data512, critic, ebm, card_line)
        lap("critic_guided")
        par = phase_parallel_ranks(par_prep)
        lap("parallel_ranks")
        # the four pipeline ranks run before any kernel is timed here
        pp = phase_pp_ranks(pp_prep)
        lap("pp_ranks")
    except BaseException:
        stop_ranks(*launches)
        raise
    del par_prep, pp_prep
    dp_trained = phase_dp_train(card_line, peak_bw, peak_ops, par)
    lap("dp_train")
    tp_trained = phase_tp_train(card_line, peak_bw, peak_ops, par)
    lap("tp_train")
    phase_tp_adafactor(card_line, par)
    lap("tp_adafactor")
    tp_served = phase_tp_serve(card_line, peak_bw, peak_ops, par)
    lap("tp_serve")
    ep_trained = phase_ep_train(card_line, peak_bw, peak_ops, par)
    lap("ep_train")
    phase_moe_dp(card_line, par)
    lap("moe_dp")
    tp_moe_served = phase_tp_moe_serve(card_line, peak_bw, peak_ops, par)
    lap("tp_moe_serve")
    del par
    pp_trained = phase_pp_train(card_line, peak_bw, peak_ops, pp)
    lap("pp_train")
    del pp
    engined = phase_engine(card_line)
    lap("engine")
    tools_dir = tempfile.TemporaryDirectory(prefix="smoke_tools_")
    (Path(tools_dir.name) / "fusion").mkdir()
    fused = phase_biophysics_fusion(Path(tools_dir.name) / "fusion", card_line)
    lap("biophysics_fusion")
    tools = phase_run_tools({"run_dir": demo_run["run_dir"], "val_npz": data512 / "val_bs512.npz"},
                            fused, prepared, Path(tools_dir.name), card_line)
    lap("run_tools")
    # the probe's start (its import and CUDA context) takes host cores: started before
    # [run_tools] it slowed phases 52-54 by more than the join it saved (one H100 machine)
    sweep = start_speed_sweep(Path(tools_dir.name))
    try:
        timing = phase_timing_tools(trained, served, Path(tools_dir.name), card_line)
        lap("timing_tools")
        diag_dir = Path(tools_dir.name) / "diagnoses"
        diag_dir.mkdir()
        diagnosed = phase_diagnoses(demo_run, data512, demo_records, diag_dir, card_line)
        lap("diagnoses")
        phase_speed_sweep(sweep, card_line)
        lap("speed_sweep")
    finally:
        stop_speed_sweep(sweep)
    represented = phase_representation(repr_worker, card_line, peak_bw, peak_ops)
    lap("representation")
    classified = phase_classifiers(cls_worker, card_line)
    lap("classifiers")
    repr_dir.cleanup()
    cls_dir.cleanup()
    tools_dir.cleanup()
    pp_dir.cleanup()
    tp_dir.cleanup()
    protein_dir.cleanup()
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
        "launches_critic_guided": guided["decode"],
        "launches_sanity_kpis": tools["decode"],
        "launches_benchmark_decode": timing["decode"],
        "launches_diagnoses": diagnosed["decode"],
        "launches_representation": represented["decode"],
        "launches_tp_serve": tp_served["runs"]["bf16"]["launches_per_rank"][0]["decode_attention"],
        "launches_tp_serve_int8": tp_served["runs"]["int8_cache"]["launches_per_rank"][0][
            "decode_attention"],
        "tp_rank_hkv4": tp_served["timed"]["rank_hkv4_bf16"],
        "tp_rank_hkv4_int8": tp_served["timed"]["rank_hkv4_int8"],
        "launches_tp_moe_serve": tp_moe_served["runs"]["bf16"]["launches_per_rank"][0][
            "decode_attention"],
        "tp_moe_rank_hkv4_d64": tp_moe_served["timed"]["decode"],
        "stress": {k: stress[k] for k in ("draws", "max_abs_err", "nan_dead_tiles_err")},
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
            "launches_dp_train": dp_trained["launches"][wrapper.__name__],
            "launches_tp_train": tp_trained["launches"][wrapper.__name__],
            "launches_ep_train": ep_trained["launches"][wrapper.__name__],
            "launches_pp_train": pp_trained["launches"][wrapper.__name__],
            "launches_hybrid_train": hybrid["launches"][wrapper.__name__],
            "launches_engine": engined["launches"][wrapper.__name__],
            "launches_biophysics_fusion": fused["launches"][wrapper.__name__],
            "launches_run_tools": tools["flash"] if key == "fwd" else 0,
            "launches_profile_train": timing["profile"][wrapper.__name__],
            "launches_diagnoses": diagnosed["flash"] if key == "fwd" else 0,
            "hybrid_b8_h8": hybrid["timed"][key],
            "dp_rank_b4_h8": dp_trained["timed"][key],
            "tp_rank_b8_h4": tp_trained["timed"][key],
            "ep_rank_b8_h4_d64": ep_trained["timed"][key],
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
                "launches_critic_guided": guided["flash"],
                "launches_representation": represented["flash"],
                "launches_classifiers": classified["flash"],
                "representation_b1": represented["flash_timed"],
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
        "launches_benchmark_decode": timing["chunk"],
        "launches_tp_spec": tp_served["runs"]["spec4"]["launches_per_rank"][0][
            "decode_attention_chunk"],
        "tp_rank_hkv4": tp_served["chunk_timed"],
        "launches_tp_moe_spec": tp_moe_served["runs"]["spec4"]["launches_per_rank"][0][
            "decode_attention_chunk"],
        "tp_moe_rank_hkv4_d64": tp_moe_served["timed"]["chunk"],
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
