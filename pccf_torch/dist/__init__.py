"""Distributed execution: the process group's helpers, the launcher, the
``(dp, mp)`` grid, the sharded-point-axis losses, and tensor, expert and
pipeline parallelism (``pccf/dist``)."""

from pccf_torch.dist.launcher import DistributedWorker, launch
from pccf_torch.dist.mesh import initialize_distributed, is_main_process, rank, shard_batch, world_size
from pccf_torch.dist.pp import pipeline_apply, pipeline_run, shard_stacked_params, stack_layer_params
from pccf_torch.dist.sharding import (Grid, ep_spec, make_2d_grid, shard_params_tp, shard_variables_ep, tp_layout,
                                      tp_spec)
from pccf_torch.dist.sp import slab, sp_chamfer, sp_knn, sp_match_cost

__all__ = ['DistributedWorker', 'Grid', 'ep_spec', 'initialize_distributed', 'is_main_process', 'launch',
           'make_2d_grid', 'pipeline_apply', 'pipeline_run', 'rank', 'shard_batch', 'shard_params_tp',
           'shard_stacked_params', 'shard_variables_ep', 'slab', 'sp_chamfer', 'sp_knn', 'sp_match_cost',
           'stack_layer_params', 'tp_layout', 'tp_spec', 'world_size']
