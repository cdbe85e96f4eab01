"""Compute ops: plain PyTorch attention, masks, KV quantization, and the
wrappers of the hand-written CUDA kernels (``csrc/``)."""
