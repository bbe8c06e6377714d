"""Frozen copy of ``sample_views_plain`` from dynibar_tpu_torch/ops/sample.py
at commit a749e58: bilinear sampling of source maps through F.grid_sample.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sample_views_plain(maps: torch.Tensor, grid: torch.Tensor
                       ) -> torch.Tensor:
  """maps [V,H,W,C], grid [V,R,S,2] (x, y in [-1, 1]) -> [V,R,S,C].

  Interpolates in f32 and rounds once to the maps' dtype."""
  v, r, s, _ = grid.shape
  out = F.grid_sample(maps.permute(0, 3, 1, 2).float(),
                      grid.reshape(v, r * s, 1, 2).float(), mode="bilinear",
                      padding_mode="zeros", align_corners=True)  # [V,C,N,1]
  return out[..., 0].permute(0, 2, 1).reshape(v, r, s, -1).to(maps.dtype)
