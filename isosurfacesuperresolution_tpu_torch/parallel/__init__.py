"""Several devices over `torch.distributed`, one process a device: data
parallel training, multi-camera rendering, the slab-sharded sweep."""

from isosurfacesuperresolution_tpu_torch.parallel.mesh import (
    make_mesh, shard_batch, make_sharded_train_step, render_cameras_sharded)
