"""The tiny training configuration of the port's trainer tests, in a file
that imports no JAX, so that the tests that run on a GPU machine without
JAX take it too."""
from d2dgs_torch.config import RasterConfig
from d2dgs_torch.train.config import TrainConfig

# the tiny configuration of tests/test_trainer.py (widths, caps and the
# ratios of its stage-1 schedule), its stage 1 cut to a third of the steps
TINY = TrainConfig(
    sh_degree=1, hyper_dim=2, node_num=16, gaussian_capacity=512,
    node_gauss_capacity=256, warm_up=30,
    node_warm_up=40, iterations_node_sampling=90,
    iterations_node_rendering=110, iterations=400,
    densification_interval=25, densify_from_iter=20,
    opacity_reset_interval=10_000, normal_dist_from_iter=150,
    oneup_sh_degree_step=100, node_force_densify_prune_step=1_000,
    raster=RasterConfig(tile_cap=256, chunk=64, use_workqueue=False))
