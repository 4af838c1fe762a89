"""Multi-device work over ``torch.distributed`` (port of
``cvvae_tpu/parallel``): meshes for inference (``mesh.py``) and sharded
net calls (``shard.py``); data-parallel training (``data.py``)."""

from cvvae_tpu_torch.parallel.data import (  # noqa: F401
    ProcessMesh, batch_sharding, check_replicated, process_mesh, put_batch,
    put_replicated, shard_parallel_step, train_state_digest)
from cvvae_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, Sharding, follow, make_mesh, multihost_init, replicated,
    spatial_sharding, temporal_sharding)
