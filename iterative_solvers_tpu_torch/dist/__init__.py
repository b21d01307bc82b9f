"""The distribution layer on ``torch.distributed``
(port of ``iterative_solvers_tpu/dist``): process groups and the device
mesh, halo exchange and sharded operators, the sharded Swift–Hohenberg and
droplet steps (``dist.solvers``, ``dist.droplet``)."""
from .mesh import make_mesh, initialize_multihost, local_block_shape  # noqa: F401
from .halo import (  # noqa: F401
    halo_exchange_1d, with_halo, sharded_lap_periodic, sharded_sh_operator,
    pdot, shard_field, gather_field, grid_sharding,
)
