"""Epipolar projection of 3D sample points into source views.

Port of ``dynibar_tpu.core.projection`` (reference ``Projector``,
ibrnet/projection.py:7-176), exact path only: the CUDA sampler is exact
for every sample, so there is no coverage mask and no channel-major twin.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from dynibar_tpu_torch.core import cameras as cam
from dynibar_tpu_torch.ops.sample import sample_views

SampleFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _normalize(v: torch.Tensor) -> torch.Tensor:
  # torch.nn.functional.normalize semantics: v / max(||v||, 1e-12)
  return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                         min=1e-12)


def project_points(xyz: torch.Tensor, src_cameras: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """xyz [V,R,S,3] -> (pixel_xy [V,R,S,2], in_front [V,R,S])
  (reference projection.py:32-59: clamped divide, positive-depth mask)."""
  _, _, k, c2w = cam.split_camera(src_cameras)
  proj_mat = k @ cam.invert_pose(c2w)                           # [V,4,4]
  xyz_h = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
  proj = torch.einsum("vij,vrsj->vrsi", proj_mat, xyz_h)
  z = torch.clamp(proj[..., 2:3], min=1e-8)
  pix = torch.clamp(proj[..., :2] / z, -1e6, 1e6)
  return pix, proj[..., 2] > 0


def inbound_mask(pixel_xy: torch.Tensor, h, w) -> torch.Tensor:
  """Valid-pixel mask (reference projection.py:13-20)."""
  x, y = pixel_xy[..., 0], pixel_xy[..., 1]
  return (x >= 0) & (x <= w - 1.0) & (y >= 0) & (y <= h - 1.0)


def ray_angle_features(xyz_st: torch.Tensor, xyz: torch.Tensor,
                       query_camera: torch.Tensor, src_cameras: torch.Tensor
                       ) -> torch.Tensor:
  """[normalized(ray2tar - ray2src), dot] -> [V,R,S,4]
  (reference projection.py:61-101)."""
  tar_pos = cam.split_camera(query_camera)[3][:3, 3]
  src_pos = cam.split_camera(src_cameras)[3][:, :3, 3]
  ray2tar = _normalize(tar_pos - xyz_st)[None]                  # [1,R,S,3]
  ray2src = _normalize(src_pos[:, None, None, :] - xyz)         # [V,R,S,3]
  dot = torch.sum(ray2tar * ray2src, dim=-1, keepdim=True)
  return torch.cat([_normalize(ray2tar - ray2src), dot], dim=-1)


def compute_with_motions(
    xyz_st: torch.Tensor,        # [R, S, 3]
    xyz: torch.Tensor,           # [V, R, S, 3]
    query_camera: torch.Tensor,  # [34]
    src_rgbs: torch.Tensor,      # [V, H, W, 3]
    src_cameras: torch.Tensor,   # [V, 34]
    featmaps: torch.Tensor,      # [V, Hf, Wf, C]
    view_valid: torch.Tensor,    # [V] 0/1 padding mask
    sample_fn: SampleFn = sample_views,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Project, gather RGB+features, angle features and masks.

  Returns rgb_feat [R,S,V,3+C], ray_diff [R,S,V,4], mask [R,S,V,1]."""
  h, w = src_cameras[0, 0], src_cameras[0, 1]
  pixel_xy, in_front = project_points(xyz, src_cameras)
  # normalized coords (align_corners=True) serve the full-res images and
  # the lower-resolution feature maps alike
  resize = torch.stack([w - 1.0, h - 1.0])
  grid = 2.0 * pixel_xy / resize - 1.0                          # [V,R,S,2]
  rgbs = sample_fn(src_rgbs, grid)                              # [V,R,S,3]
  feats = sample_fn(featmaps, grid)                             # [V,R,S,C]
  rgb_feat = torch.cat([rgbs, feats], dim=-1)
  mask = inbound_mask(pixel_xy, h, w) & in_front
  mask = mask & (view_valid[:, None, None] > 0)
  ray_diff = ray_angle_features(xyz_st, xyz, query_camera, src_cameras)
  return (rgb_feat.permute(1, 2, 0, 3), ray_diff.permute(1, 2, 0, 3),
          mask.permute(1, 2, 0).to(rgb_feat.dtype)[..., None])


def ref_plucker(ray_o: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
  """Plücker coordinates of target rays [R, 6]
  (reference render_ray.py:372-377)."""
  d = _normalize(ray_d)
  return torch.cat([d, torch.linalg.cross(ray_o, d, dim=-1)], dim=-1)


def src_plucker(pts: torch.Tensor, src_cameras: torch.Tensor) -> torch.Tensor:
  """Plücker coordinates of source->point rays, pts [R,S,3] -> [R,S,V,6]
  (reference render_ray.py:380-396)."""
  origins = cam.split_camera(src_cameras)[3][:, :3, 3]          # [V,3]
  ray = _normalize(pts[None] - origins[:, None, None, :])       # [V,R,S,3]
  o = origins[:, None, None, :].expand(ray.shape)
  out = torch.cat([ray, torch.linalg.cross(o, ray, dim=-1)], dim=-1)
  return out.permute(1, 2, 0, 3)
