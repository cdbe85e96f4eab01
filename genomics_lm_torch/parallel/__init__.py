"""Parallelism layer: process meshes, sharding rules, tensor parallelism.

Twin of ``genomics_lm_tpu/parallel/__init__.py``, with its mesh exports;
not the pipeline's (GPipe is not ported yet), nor its spec-tree helpers,
which lay arrays out for ``jax.device_put`` (``sharding.py`` says what
takes their place). JAX runs a mesh of devices in one program; here a mesh
is laid over the ranks of a process group, one process per card (``mesh.py``), data parallelism reduces gradients and
splits optimizer state across the data axis (``training/train_step.py``,
``training/optim.py``), and Megatron tensor and sequence parallelism call
their collectives from the forward (``tensor_parallel.py``).
"""

from genomics_lm_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    initialize_distributed,
    local_device_count,
    make_mesh,
)
from genomics_lm_torch.parallel.sharding import tp_spec, zero1_owners  # noqa: F401
