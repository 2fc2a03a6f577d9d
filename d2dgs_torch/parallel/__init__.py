"""Multi-rank scaling (counterpart of d2dgs_tpu/parallel/): the
data-parallel step, the Gaussian- and tile-sharded renderer with its
tile-binning exchange, and the (data x gauss) sharded training step.

The JAX package shards arrays over a device mesh and lets XLA place the
collectives.  The port runs one process per rank (``torchrun``, or
``multihost.run_local`` for a local CPU run) with explicit
``torch.distributed`` collectives: NCCL on CUDA, gloo on the CPU.
"""
from .data_parallel import (add_stats_batched, batched_main_step,
                            make_dp_main_step, stack_cameras)
from .gauss_shard import (measure_exchange_counts, pad_to_multiple,
                          render_gauss_sharded, shard_gaussians,
                          suggest_exchange_cap)
from .gauss_train import (gather_gauss_state, gauss_sharded_step,
                          make_gauss_mesh, make_gauss_sharded_step,
                          make_mesh2d, make_sharded_train_step,
                          shard_gauss_state, sharded_train_step)
from .multihost import (RankGrid, global_mesh, is_primary,
                        maybe_init_distributed, run_local)

__all__ = [
    "add_stats_batched", "batched_main_step", "make_dp_main_step",
    "stack_cameras", "measure_exchange_counts", "pad_to_multiple",
    "render_gauss_sharded", "shard_gaussians", "suggest_exchange_cap",
    "gather_gauss_state", "gauss_sharded_step", "make_gauss_mesh",
    "make_gauss_sharded_step", "make_mesh2d", "make_sharded_train_step",
    "shard_gauss_state", "sharded_train_step", "RankGrid", "global_mesh",
    "is_primary", "maybe_init_distributed", "run_local",
]
