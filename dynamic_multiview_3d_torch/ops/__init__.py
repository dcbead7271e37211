"""Geometry ops: pose encodings, camera math, depth reprojection, plain
bilinear sampling.

Plain PyTorch; the sampling functions are the oracle for the hand-written
kernels in ``kernels/``.
"""

from dynamic_multiview_3d_torch.ops.pose import (
    encode_pose,
    encode_view_pair,
    intrinsics_matrix,
    look_at_extrinsics,
    pose_to_features,
    relative_transform,
)
from dynamic_multiview_3d_torch.ops.reproject import (
    depth_reproject_sample,
    inv3x3,
    reproject_coords,
)
from dynamic_multiview_3d_torch.ops.sampling import (
    base_grid,
    flow_warp,
    grid_sample,
    in_bounds_mask,
    normalize_coords,
    unnormalize_coords,
)

__all__ = [
    "encode_pose", "encode_view_pair", "intrinsics_matrix",
    "look_at_extrinsics", "pose_to_features", "relative_transform",
    "base_grid", "flow_warp", "grid_sample", "in_bounds_mask",
    "normalize_coords", "unnormalize_coords",
    "depth_reproject_sample", "inv3x3", "reproject_coords",
]
