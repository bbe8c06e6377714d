"""Optical-flow IO and warping.

Port of ``dynibar_tpu.data.flow_io`` (reference
ibrnet/data_loaders/flow_utils.py ``warp_flow``, :6-22, and the flow .npz
reading convention, monocular.py:91-112).  ``warp_flow`` runs on tensors
on their own device, with no cv2: it reproduces ``cv2.remap`` with
``INTER_LINEAR`` and the default constant border (0) as OpenCV 5 computes
it for a float map, bilinear at the map's exact coordinate.  (OpenCV 4
rounded the coordinate to 1/32 pixel first, which moves a value by up to
1/64 pixel times the image's gradient.)
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch


def read_optical_flow(scene_path: str, frame_idx: int, fwd: bool,
                      interval: int) -> Tuple[np.ndarray, np.ndarray]:
  """Load flow_i<interval>/<frame>_{fwd,bwd}.npz -> (flow [H,W,2], mask)."""
  tag = "fwd" if fwd else "bwd"
  path = os.path.join(scene_path, f"flow_i{interval}",
                      f"{frame_idx:05d}_{tag}.npz")
  data = np.load(path)
  return data["flow"], np.float32(data["mask"])


def warp_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
  """Backward-warp ``img`` [H', W'(, C)] by ``flow`` [H, W, 2] (bilinear):
  out(x) = img(x + flow(x)), [H, W(, C)] on ``img``'s device, a tap that
  falls outside the image counting as 0.  A uint8 image is interpolated
  in float32 and rounded (cv2 interpolates it in fixed point: at most one
  level apart)."""
  h, w = flow.shape[:2]
  sh, sw = img.shape[:2]
  dev = img.device
  flow = flow.to(dev, torch.float32)
  x = flow[..., 0] + torch.arange(w, device=dev, dtype=torch.float32)
  y = flow[..., 1] + torch.arange(h, device=dev,
                                  dtype=torch.float32)[:, None]
  x0, y0 = torch.floor(x), torch.floor(y)
  fx, fy = (x - x0)[..., None], (y - y0)[..., None]
  x0, y0 = x0.long(), y0.long()
  src = img.float()
  flat = src.reshape(sh * sw, -1)

  def tap(yy, xx):
    inside = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
    idx = (yy.clamp(0, sh - 1) * sw + xx.clamp(0, sw - 1)).reshape(-1)
    return torch.where(inside[..., None], flat[idx].reshape(h, w, -1), 0.0)

  gx, gy = 1 - fx, 1 - fy
  out = (tap(y0, x0) * (gy * gx) + tap(y0, x0 + 1) * (gy * fx)
         + tap(y0 + 1, x0) * (fy * gx) + tap(y0 + 1, x0 + 1) * (fy * fx))
  out = out.reshape((h, w) + tuple(img.shape[2:]))
  if img.dtype == torch.uint8:
    return out.round().clamp(0, 255).to(torch.uint8)
  return out.to(img.dtype)
