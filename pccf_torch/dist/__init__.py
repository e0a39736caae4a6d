"""Data parallelism: the process group's helpers and the launcher
(``pccf/dist``)."""

from pccf_torch.dist.launcher import DistributedWorker, launch
from pccf_torch.dist.mesh import initialize_distributed, is_main_process, rank, shard_batch, world_size

__all__ = ['DistributedWorker', 'initialize_distributed', 'is_main_process', 'launch', 'rank', 'shard_batch',
           'world_size']
