"""Parallelism layer: process meshes, sharding rules, tensor, expert and
pipeline parallelism.

Twin of ``genomics_lm_tpu/parallel/__init__.py``, with its mesh and
pipeline exports; not its spec-tree helpers, which lay arrays out for
``jax.device_put`` (``sharding.py`` says what takes their place). JAX runs a
mesh of devices in one program; here a mesh is laid over the ranks of a
process group, one process per card (``mesh.py``). Data parallelism
reduces gradients and splits optimizer state across the data axis
(``training/train_step.py``, ``training/optim.py``); Megatron tensor and
sequence parallelism, and expert parallelism over the same model axis,
call their collectives from the forward (``tensor_parallel.py``); GPipe
runs a stage of the blocks on each rank of the pipe axis (``pipeline.py``).
"""

from genomics_lm_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    initialize_distributed,
    local_device_count,
    make_mesh,
)
from genomics_lm_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_eval_step,
    make_pipeline_group_step,
    merge_stage_params,
    split_stage_params,
)
from genomics_lm_torch.parallel.sharding import ep_spec, tp_spec, zero1_owners  # noqa: F401
