"""Compute ops: plain PyTorch attention, masks, KV quantization, the
cross-entropy loss, and the wrappers of the hand-written CUDA kernels
(``csrc/``)."""
