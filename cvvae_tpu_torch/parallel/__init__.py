"""Multi-device inference over ``torch.distributed`` (port of
``cvvae_tpu/parallel``): meshes (``mesh.py``) and sharded net calls
(``shard.py``)."""

from cvvae_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, Sharding, follow, make_mesh, multihost_init, replicated,
    spatial_sharding, temporal_sharding)
