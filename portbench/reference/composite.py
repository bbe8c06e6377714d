"""Frozen copy of dynibar_tpu_torch/core/composite.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

Volume-rendering composition of the static + dynamic fields.

Port of ``dynibar_tpu.core.composite`` (reference render_ray.py:134-358):
softplus density, unit distances with a 1e10 tail, cumprod transmittance
with the 1e-10 epsilon, and the ">8 valid samples" per-ray mask.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import cameras as cam


def _sigma2alpha(sigma: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
  return 1.0 - torch.exp(-F.softplus(sigma) * dists)


def _unit_dists(z_vals: torch.Tensor) -> torch.Tensor:
  return torch.cat([torch.ones_like(z_vals[..., 1:]),
                    torch.full_like(z_vals[..., :1], 1e10)], dim=-1)


def _transmittance(alpha: torch.Tensor) -> torch.Tensor:
  t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)[..., :-1]
  return torch.cat([torch.ones_like(t[..., :1]), t], dim=-1)


def composite_single(raw: torch.Tensor, z_vals: torch.Tensor,
                     pixel_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
  """Single-field composition (raw2outputs_vanilla).  raw [R,S,4]."""
  alpha = _sigma2alpha(raw[..., 3], _unit_dists(z_vals))
  weights = alpha * _transmittance(alpha)
  return {
      "rgb": torch.sum(weights[..., None] * raw[..., :3], dim=-2),
      "depth": torch.sum(weights * z_vals, dim=-1),
      "weights": weights,
      "mask": torch.sum(pixel_mask.float(), dim=-1) > 8,
      "alpha": alpha,
      "z_vals": z_vals,
  }


def composite_dual(raw_dy: torch.Tensor, raw_st: torch.Tensor,
                   z_vals: torch.Tensor, mask_dy: torch.Tensor,
                   mask_st: torch.Tensor) -> Dict[str, torch.Tensor]:
  """Two-field composition (raw2outputs): 1-α = (1-α_st)(1-α_dy)."""
  dists = _unit_dists(z_vals)
  alpha_dy = _sigma2alpha(raw_dy[..., 3], dists)
  alpha_st = _sigma2alpha(raw_st[..., 3], dists)
  alpha = 1.0 - (1.0 - alpha_st) * (1.0 - alpha_dy)
  t = _transmittance(alpha)
  weights_dy = alpha_dy * t
  weights_st = alpha_st * t
  weights = alpha * t
  rgb_dy = torch.sum(weights_dy[..., None] * raw_dy[..., :3], dim=-2)
  rgb_st = torch.sum(weights_st[..., None] * raw_st[..., :3], dim=-2)
  mask = ((torch.sum(mask_dy.float(), dim=-1) > 8)
          | (torch.sum(mask_st.float(), dim=-1) > 8))
  return {
      "rgb": rgb_dy + rgb_st,
      "rgb_static": rgb_st,
      "rgb_dy": rgb_dy,
      "depth": torch.sum(weights * z_vals, dim=-1),
      "depth_dy": torch.sum(weights_dy * z_vals, dim=-1),
      "alpha_dy": alpha_dy,
      "weights_dy": weights_dy,
      "weights_st": weights_st,
      "alpha": alpha,
      "weights": weights,
      "mask": mask,
      "z_vals": z_vals,
  }


def render_optical_flow(weights: torch.Tensor, pts_3d_seq: torch.Tensor,
                        src_cameras: torch.Tensor, uv_grid: torch.Tensor
                        ) -> torch.Tensor:
  """2D flow of the expected trajectory point [V, R, 2]
  (reference render_ray.py:333-358, with a guarded perspective divide)."""
  _, _, k, c2w = cam.split_camera(src_cameras)
  w2c = cam.invert_pose(c2w)
  exp_pts = torch.sum(weights[None, ..., None] * pts_3d_seq, dim=-2)
  pts_src = (torch.einsum("vij,vrj->vri", w2c[:, :3, :3], exp_pts)
             + w2c[:, None, :3, 3])
  pix = torch.einsum("vij,vrj->vri", k[:, :3, :3], pts_src)
  z = pix[..., -1:]
  tiny = torch.where(z < 0, torch.full_like(z, -1e-8),
                     torch.full_like(z, 1e-8))
  z = torch.where(torch.abs(z) < 1e-8, tiny, z)
  return torch.clamp((pix / z)[..., :2], -1e6, 1e6) - uv_grid[None]
