from rtwc_tpu_torch.dist.mesh import (
    TILE_AXIS,
    make_mesh,
    render_frame_sharded,
    make_sharded_train_step,
)
from rtwc_tpu_torch.dist.multihost import initialize_multihost, shutdown_multihost

__all__ = [
    "TILE_AXIS",
    "make_mesh",
    "render_frame_sharded",
    "make_sharded_train_step",
    "initialize_multihost",
    "shutdown_multihost",
]
