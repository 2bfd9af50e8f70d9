"""Multi-device scaling (the meshes and their helpers live in
``core.mesh``): :func:`launch` starts the SPMD ranks, ``sync_bn`` holds the
global-batch BatchNorm, ``dryrun`` drives the production paths on n
ranks."""

from ..core.mesh import (get_mesh, ensemble_mesh, data_sharding, replicate,
                         shard_batch, DATA_AXIS, MODEL_AXIS)
from .launch import launch

__all__ = ["get_mesh", "ensemble_mesh", "data_sharding", "replicate",
           "shard_batch", "DATA_AXIS", "MODEL_AXIS"]
