"""Data parallelism over torch.distributed: the mesh and its groups, the
collective transpilers, ZeRO-1 and the data-parallel rewrite; tensor
parallelism (the Megatron rewrite over a `tp` axis); and pipeline
parallelism (the stage split and its schedules)."""
from .collective import (Collective, GradAllReduce, LocalSGD,  # noqa: F401
                         build_buckets, resolve_bucket_mb)
from .mesh import (CommContext, DATA_AXIS, EXPERT_AXIS,  # noqa: F401
                   MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh, axes_desc,
                   get_comm_context, make_mesh, make_tp_mesh)
from .pipeline import (PipelinePlan, bubble_fraction,  # noqa: F401
                       build_pipeline_plan)
from .sharding import (ZERO1_OP_TYPES, annotate_sharding,  # noqa: F401
                       annotation_spec, apply_zero1, data_parallel_rewrite)
from .tensor_parallel import tensor_parallel_rewrite  # noqa: F401
