"""Build and load the hand-written CUDA kernels of ``csrc/`` (see ``build.py``)."""
