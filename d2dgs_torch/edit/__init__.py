"""Interactive editing of the control nodes (counterpart of
d2dgs_tpu/edit): the ARAP deformer, the LapDeform facade and the
keypoint bookkeeping."""
from .arap import ArapGraph, arap_deform, build_graph, deform_energy
from .keypoints import DeformKeypoints
from .lap_deform import LapDeform

__all__ = ["ArapGraph", "arap_deform", "build_graph", "deform_energy",
           "DeformKeypoints", "LapDeform"]
