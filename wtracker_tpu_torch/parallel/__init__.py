"""Multi-device scale-out: meshes, stream sharding, data-parallel training."""

from wtracker_tpu_torch.parallel.mesh import (
    make_dp_train_step,
    make_mesh,
    pad_streams,
    replicated,
    run_engine_sharded,
    stream_sharding,
)

__all__ = [
    "make_dp_train_step",
    "make_mesh",
    "pad_streams",
    "replicated",
    "run_engine_sharded",
    "stream_sharding",
]
