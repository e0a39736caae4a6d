"""Distributed execution: the process group's helpers, the launcher, the
``(dp, mp)`` grid and the sharded-point-axis losses (``pccf/dist``)."""

from pccf_torch.dist.launcher import DistributedWorker, launch
from pccf_torch.dist.mesh import initialize_distributed, is_main_process, rank, shard_batch, world_size
from pccf_torch.dist.sharding import Grid, make_2d_grid
from pccf_torch.dist.sp import slab, sp_chamfer, sp_knn, sp_match_cost

__all__ = ['DistributedWorker', 'Grid', 'initialize_distributed', 'is_main_process', 'launch', 'make_2d_grid', 'rank',
           'shard_batch', 'slab', 'sp_chamfer', 'sp_knn', 'sp_match_cost', 'world_size']
