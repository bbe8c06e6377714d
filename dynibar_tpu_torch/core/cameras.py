"""Camera codec and ray generation.

The camera format is 34 floats ``[H, W, K.flatten(16), c2w.flatten(16)]``
(reference ibrnet/sample_ray.py:11-16).  All geometry runs in full f32:
the entry points turn TF32 off (utils/device.resolve_device).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_camera(h: int, w: int, intrinsics, c2w) -> np.ndarray:
  """Pack a 34-float camera vector (numpy, host-side)."""
  return np.concatenate(
      [np.array([h, w], dtype=np.float32),
       np.asarray(intrinsics, dtype=np.float32).reshape(16),
       np.asarray(c2w, dtype=np.float32).reshape(16)]).astype(np.float32)


def split_camera(camera: torch.Tensor) -> Tuple[torch.Tensor, ...]:
  """[..., 34] -> (H, W, K [...,4,4], c2w [...,4,4])."""
  lead = camera.shape[:-1]
  return (camera[..., 0], camera[..., 1],
          camera[..., 2:18].reshape(lead + (4, 4)),
          camera[..., 18:34].reshape(lead + (4, 4)))


def invert_pose(c2w: torch.Tensor) -> torch.Tensor:
  """Rigid inverse (Rᵀ, -Rᵀt) of [..., 4, 4] camera-to-world matrices."""
  r = c2w[..., :3, :3]
  t = c2w[..., :3, 3:]
  rt = r.transpose(-1, -2)
  top = torch.cat([rt, -(rt @ t)], dim=-1)
  bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype,
                        device=c2w.device).expand(c2w.shape[:-2] + (1, 4))
  return torch.cat([top, bottom], dim=-2)


def pixel_rays(h: int, w: int, intrinsics: torch.Tensor, c2w: torch.Tensor,
               stride: int = 1) -> Tuple[torch.Tensor, ...]:
  """All-pixel rays of one camera (reference sample_ray.py:143-163).

  Pixel grid (u=x, v=y) with no half-pixel offset; direction =
  c2w[:3,:3] @ K^-1 @ [u, v, 1].  Returns (rays_o, rays_d, uv), each [N,·].
  """
  dev = intrinsics.device
  u = torch.arange(0, w, stride, dtype=torch.float32, device=dev)
  v = torch.arange(0, h, stride, dtype=torch.float32, device=dev)
  vv, uu = torch.meshgrid(v, u, indexing="ij")
  uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)
  pix = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1)
  kinv = torch.linalg.inv(intrinsics[:3, :3])
  dirs = (c2w[:3, :3] @ (kinv @ pix.T)).T
  origins = c2w[:3, 3].expand(dirs.shape)
  return origins, dirs, uv


def intrinsics_from_hwf(h: float, w: float, f: float) -> np.ndarray:
  """LLFF hwf -> 4x4 K (reference llff_data_utils.py:22-24)."""
  return np.array(
      [[f, 0, w / 2.0, 0], [0, f, h / 2.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
      dtype=np.float32)
