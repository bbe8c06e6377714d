"""mip-NeRF-360 distortion loss in closed form (port of
``dynibar_tpu.ops.distortion.eff_distloss``).

  L = sum_ij w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 interval_i

For sorted midpoints the pairwise term is 2 sum_i w_i (m_i P_i - Q_i) with
the exclusive prefix sums P_i = sum_{j<i} w_j and Q_i = sum_{j<i} w_j m_j:
two cumsums, no N x N term.  The result is the mean over rays; under a
mesh, over the mesh's rays (this rank's sum over the global count).
"""

from __future__ import annotations

import torch


def eff_distloss(weights: torch.Tensor, midpoints: torch.Tensor,
                 intervals: torch.Tensor, mesh=None) -> torch.Tensor:
  """weights, midpoints (ascending), intervals [R, M] -> scalar."""
  w, m = weights, midpoints
  p = torch.cumsum(w, dim=-1) - w
  q = torch.cumsum(w * m, dim=-1) - w * m
  cross = 2.0 * torch.sum(w * (m * p - q), dim=-1)
  self_term = torch.sum(w * w * intervals, dim=-1) / 3.0
  loss = torch.mean(cross + self_term)
  return loss if mesh is None else loss / mesh.world
