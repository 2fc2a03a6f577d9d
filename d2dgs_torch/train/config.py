"""Training configuration (counterpart of d2dgs_tpu/train/config.py): the
reference's arguments/__init__.py (ModelParams / OptimizationParams /
PipelineParams) as a frozen dataclass with the same defaults, the D-NeRF
recipe of script/train9.sh (``--is_blender --gt_alpha_mask_as_scene_mask
--local_frame``).
"""
from __future__ import annotations

import dataclasses

from ..config import RasterConfig
from ..models.deform import DeformConfig
from ..models.deform_mlp import MLPConfig
from ..models.nodes import NodeConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # model (ModelParams, arguments/__init__.py:50-98)
    sh_degree: int = 3
    # node (ControlNodeWarp, the D-2DGS default) | mlp | hash | static
    deform_type: str = "node"
    progressive_band_time: bool = False
    hyper_dim: int = 8
    node_num: int = 1024
    K: int = 3
    is_blender: bool = True
    local_frame: bool = True
    d_rot_as_res: bool = True
    white_background: bool = False
    gaussian_capacity: int = 200_000
    node_gauss_capacity: int = 32_768   # stage-1 isotropic point budget

    # optimization (OptimizationParams, arguments/__init__.py:99-158)
    iterations: int = 80_000
    warm_up: int = 3_000
    dynamic_color_warm_up: int = 20_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    deform_lr_max_steps: int = 40_000
    deform_lr_scale: float = 1.0
    feature_lr: float = 0.004
    opacity_lr: float = 0.05
    scaling_lr: float = 0.002
    rotation_lr: float = 0.002
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    spatial_lr_scale: float = 5.0

    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 50_000
    densify_grad_threshold: float = 2e-4
    oneup_sh_degree_step: int = 1_000

    # node pre-training stage (arguments/__init__.py:127-139)
    node_warm_up: int = 2_000
    iterations_node_sampling: int = 7_500
    iterations_node_rendering: int = 10_000
    node_enable_densify_prune: bool = False
    node_densification_interval: int = 5_000
    node_densify_from_iter: int = 1_000
    node_densify_until_iter: int = 25_000
    node_force_densify_prune_step: int = 10_000

    # progressive time-window curriculum (arguments/__init__.py:141-144)
    progressive_train: bool = False
    progressive_stage_ratio: float = 0.2
    progressive_stage_steps: int = 3_000

    # losses (train_gui.py:292-293, 500-507)
    lambda_normal: float = 0.02
    lambda_dist: float = 1000.0
    normal_dist_from_iter: int = 8_000
    lambda_elastic: float = 1e-3
    lambda_acc: float = 1e-5
    lambda_node_arap: float = 1e-2
    no_arap_loss: bool = False

    # motion-mask loss (train_gui.py:363-370, 509-515; needs the views'
    # gt alpha masks) and optical-flow loss (train_gui.py:318-361; needs
    # raft_neighbouring/ flow files, data/flow.py)
    gt_alpha_mask_as_dynamic_mask: bool = False
    no_motion_mask_loss: bool = False
    lambda_motion_mask_landmarks: tuple = (5e-1, 1e-2, 0.0)
    lambda_motion_mask_steps: tuple = (0, 10_000, 10_001)
    lambda_optical_landmarks: tuple = (1e-1, 1e-1, 1e-3, 0.0)
    lambda_optical_steps: tuple = (0, 15_000, 25_000, 25_001)

    raster: RasterConfig = RasterConfig()

    @property
    def node_cfg(self) -> NodeConfig:
        return NodeConfig(
            node_num=self.node_num, K=self.K, hyper_dim=self.hyper_dim,
            d_rot_as_res=self.d_rot_as_res,
            mlp=MLPConfig(is_blender=self.is_blender,
                          local_frame=self.local_frame,
                          progressive_band_time=self.progressive_band_time))

    @property
    def deform_cfg(self) -> DeformConfig:
        """DeformConfig for the facade dispatch (models/deform.py); the
        standalone-MLP field skips local_frame (reference DeformNetwork
        path, scene/deform_model.py:13-16)."""
        nc = self.node_cfg
        return DeformConfig(deform_type=self.deform_type, node=nc,
                            mlp=dataclasses.replace(nc.mlp,
                                                    local_frame=False))

    @property
    def deform_lr_init(self) -> float:
        return (self.position_lr_init * self.spatial_lr_scale
                * self.deform_lr_scale)

    @property
    def deform_lr_final(self) -> float:
        return self.position_lr_final * self.deform_lr_scale
