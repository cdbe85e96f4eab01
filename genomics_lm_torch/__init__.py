"""genomics_lm_torch — the PyTorch/CUDA port of ``genomics_lm_tpu``.

The JAX package beside this one is the reference: every module here keeps
the path and the public names of its JAX counterpart, so a reader finds
each twin, and the ``tests/test_torch_*.py`` suites hold the two against
each other on the same numpy inputs. This package imports ``torch`` and
numpy only — never ``jax`` and nothing of ``genomics_lm_tpu``; where it
needs a numpy-only module of the JAX package (the codon vocabulary, the
data layer, the run config) it keeps its own copy.

Every Pallas kernel on a ported path becomes a kernel written by hand for
Hopper (``sm_90a``) under ``csrc/``, built at first use by
``kernels/build.py``. Each kernel wrapper runs its plain PyTorch version
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.

Layer map (ported so far — the continuous-batching serving path,
speculative serving, the training step and the trainer with its one-card
options: LoRA fine-tuning and merging, remat, the auxiliary objectives,
shape guidance, Adafactor, ``grad_clip``, frozen groups, the primary
training contract and expansion; weight-only int8 serving, run loading,
constrained generation, perplexity and mutation scoring with their CLIs):

- ``tokenizers`` — codon vocabulary ids, ``to_ids`` / ``decode_ids``
- ``data``       — lossless packing, packed datasets with ``EpochPlan`` and
  grouped batches, the CUDA-stream ``DevicePrefetcher``, dataset
  manifests, vocabulary contracts and replay batches (numpy copies of the
  JAX modules)
- ``models``     — ``CodonGPTConfig``, the ``CodonGPT`` forward (loss,
  dropout, LoRA adapters and remat included) and the biophysics shape
  encoder
- ``ops``        — attention, masks, int8 KV and weight-only quantization, the
  cross-entropy loss and the auxiliary objectives, and the wrappers of the decode-attention kernels
  (``csrc/decode_attention*.cu``) and the flash-attention kernels
  (``csrc/flash_attention.cu``)
- ``generation`` — KV-cached prefill / decode / ``generate_tokens``, the
  constrained CDS generators and the ``sample``, ``query_model`` and
  ``benchmark_red`` CLIs
- ``evals``      — run loading (``playground``), perplexity and context
  ablation, in-silico mutagenesis and the ``score_mutations`` CLI
- ``parallel``   — process meshes over the ranks of a process group, the
  JAX sharding rules mapped onto the port's parameters, Megatron tensor
  and sequence parallelism, the data-parallel loss shares, and the
  launcher and rank workers the tests and the smoke spawn
- ``serving``    — ``ServingEngine`` (continuous batching, speculative
  decoding), the HTTP ``InferenceServer`` and the ``serve_model`` and
  ``benchmark_serving`` CLIs
- ``training``   — AdamW or Adafactor in the fast/base/lora groups with
  frozen labels, ``grad_clip`` and ZeRO-1, the accumulation-group step with the
  composite loss, the ``.npz`` checkpoints of the JAX package, the run
  lifecycle, the primary contract, ``run_training`` with its CLI
  (``train_codon_lm``, one process or a data / model mesh of them), LoRA on checkpoint trees (``lora``,
  ``merge_lora``), ``expansion`` and ``benchmark_lora``
- ``utils``      — device selection, the JAX-tree weight maps and the CLIs'
  shared run-directory and open-loop latency helpers

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA and no explicit device they raise rather than fall back.
"""

__version__ = "0.1.0"
