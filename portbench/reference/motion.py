"""Frozen copy of dynibar_tpu_torch/core/motion.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

Motion-trajectory field: DCT basis + coefficient evaluation.

Parity targets: ``init_dct_basis`` (reference model.py:18-30),
``compute_traj_pts`` (render_ray.py:361-369) and the per-render trajectory
window (render_ray.py:956-995).  The whole [-w, w] window is one einsum
against a [2w+1, K] basis block.
"""

from __future__ import annotations

import numpy as np
import torch


def init_dct_basis(num_basis: int, num_frames: int) -> np.ndarray:
  """DCT-II basis, [T, K] (reference model.py:18-30)."""
  t = np.arange(num_frames)[:, None].astype(np.float64)
  k = np.arange(1, num_basis + 1)[None, :].astype(np.float64)
  basis = np.sqrt(2.0 / num_frames) * np.cos(
      np.pi / (2.0 * num_frames) * (2 * t + 1) * k)
  return basis.astype(np.float32)


def zero_tail_coeffs(raw_coeff: torch.Tensor, n_samples: int) -> torch.Tensor:
  """Zero the coefficients of the last 10% samples along the ray
  (reference render_ray.py:961-962): far samples stay static."""
  num_last = int(round(n_samples * 0.1))
  if num_last == 0:
    return raw_coeff
  keep = torch.arange(n_samples, device=raw_coeff.device) < (
      n_samples - num_last)
  return raw_coeff * keep[None, :, None].to(raw_coeff.dtype)


def basis_window(trajectory_basis: torch.Tensor, frame_idx: torch.Tensor,
                 window: int = 3) -> torch.Tensor:
  """Rows [frame_idx-window .. frame_idx+window] of the [T, K] basis, each
  row index clamped on its own so the window stays aligned at the ends."""
  t = trajectory_basis.shape[0]
  offsets = torch.arange(-window, window + 1,
                         device=trajectory_basis.device)
  rows = torch.clamp(frame_idx.to(torch.int64) + offsets, 0, t - 1)
  return trajectory_basis[rows]


def traj_points_window(raw_coeff: torch.Tensor, basis_win: torch.Tensor
                       ) -> torch.Tensor:
  """raw_coeff [R, S, 3K] (x, y, z coefficient blocks); basis_win [O, K]
  -> trajectory points [R, S, O, 3]."""
  r, s, three_k = raw_coeff.shape
  k = basis_win.shape[1]
  assert three_k == 3 * k
  coeff = raw_coeff.reshape(r, s, 3, k)
  return torch.einsum("rsck,ok->rsoc", coeff, basis_win)


def displaced_points(pts: torch.Tensor, traj_win: torch.Tensor,
                     view_offset_idx: torch.Tensor, window: int = 3
                     ) -> torch.Tensor:
  """Per-view motion-displaced points [V, R, S, 3].

  pts [R,S,3]; traj_win [R,S,O,3]; view_offset_idx [V] index into the
  window (offset + window)."""
  traj_sel = traj_win[:, :, view_offset_idx.to(torch.int64)]   # [R,S,V,3]
  disp = traj_sel - traj_win[:, :, window:window + 1, :]
  return disp.permute(2, 0, 1, 3) + pts[None]


def scene_flow_seq(traj_win: torch.Tensor) -> torch.Tensor:
  """Consecutive-offset scene flows [O-1, R, S, 3] for the trajectory
  regularizer (reference render_ray.py:1101-1105)."""
  return (traj_win[:, :, 1:, :] - traj_win[:, :, :-1, :]).permute(2, 0, 1, 3)


def expected_scene_flow(weights: torch.Tensor, traj_win: torch.Tensor,
                        step: int, window: int = 3) -> torch.Tensor:
  """max(E[traj(+step)-traj(0)], E[traj(-step)-traj(0)]) under the render
  weights (reference render_ray.py:585-595 uses step=2)."""
  base = traj_win[:, :, window, :]
  w = weights[..., None]
  sf_p = torch.sum(w * (traj_win[:, :, window + step, :] - base), dim=-2)
  sf_m = torch.sum(w * (traj_win[:, :, window - step, :] - base), dim=-2)
  return torch.maximum(sf_p, sf_m)
