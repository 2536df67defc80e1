"""Multi-GPU data parallelism over ``torch.distributed`` (counterpart of
:mod:`ich_tpu.parallel`): the mesh and collectives (:mod:`.mesh`) and
multi-rank volume inference (:mod:`.sharded_inference`)."""

from ich_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather,
    all_reduce_mean,
    all_reduce_sum,
    average_gradients,
    barrier,
    get_mesh,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    replicate,
    set_default_mesh,
    shard_batch,
)
from ich_tpu_torch.parallel.sharded_inference import (  # noqa: F401
    sliding_window_inference_sharded,
    sliding_window_inference_volume_parallel,
    volume_parallel_map,
)
