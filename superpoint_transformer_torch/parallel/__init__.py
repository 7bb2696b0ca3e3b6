"""Data-parallel and graph-partition-parallel training and serving over
`torch.distributed`: counterparts of `superpoint_transformer_tpu/
parallel/`."""
from .collectives import (all_reduce_sum, all_reduce_min, all_reduce_max,
                          all_gather_rows, all_reduce_mean_)
from .mesh import (Mesh, make_data_mesh, make_dp_train_step,
                   make_shard_mesh, make_sharded_forward,
                   make_sharded_train_step)
from .multihost import run_ranks, make_global_batch, launch_multihost_dryrun
from .shard_nag import shard_padded_nag
