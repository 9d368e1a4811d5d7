from .sharding import (
    make_mesh,
    render_epoch_sharded,
    render_frame_sharded,
    replicate_scene,
    sample_active_sharded,
    shard_pixels,
)

__all__ = [
    "make_mesh",
    "render_epoch_sharded",
    "render_frame_sharded",
    "replicate_scene",
    "sample_active_sharded",
    "shard_pixels",
]
