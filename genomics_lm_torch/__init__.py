"""genomics_lm_torch — the PyTorch/CUDA port of ``genomics_lm_tpu``.

The JAX package beside this one is the reference: every module here keeps
the path and the public names of its JAX counterpart, so a reader finds
each twin, and the ``tests/test_torch_*.py`` suites hold the two against
each other on the same numpy inputs. This package imports ``torch`` and
numpy only — never ``jax`` and nothing of ``genomics_lm_tpu``; where it
needs a numpy-only module of the JAX package (the codon vocabulary) it
keeps its own copy.

Every Pallas kernel on a ported path becomes a kernel written by hand for
Hopper (``sm_90a``) under ``csrc/``, built at first use by
``kernels/build.py``. Each kernel wrapper runs its plain PyTorch version
only for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.

Layer map (ported so far — the continuous-batching serving path):

- ``tokenizers`` — codon vocabulary ids, ``to_ids`` / ``decode_ids``
- ``models``     — ``CodonGPTConfig`` and the ``CodonGPT`` inference forward
- ``ops``        — plain attention, masks, int8 KV quantization, and the
  decode-attention kernel wrapper (``csrc/decode_attention.cu``)
- ``generation`` — KV-cached prefill / decode / ``generate_tokens``
- ``serving``    — ``ServingEngine`` (continuous batching) and the HTTP
  ``InferenceServer``
- ``utils``      — device selection and the JAX-weights loader

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA and no explicit device they raise rather than fall back.
"""

__version__ = "0.1.0"
