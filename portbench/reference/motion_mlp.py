"""Frozen copy of dynibar_tpu_torch/models/motion_mlp.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

Motion-trajectory coefficient MLP (reference mlp_network.py:558-618).

8×256 ReLU MLP over the xyzt encoding (16 linearly spaced frequencies), a
skip concatenation after layer 4, and a zero-initialized coefficient head
so trajectories start at identity (as the JAX package initializes it).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.posenc import periodic_embed


class MotionMLP(nn.Module):

  def __init__(self, num_basis: int = 6, depth: int = 8, width: int = 256,
               num_freqs: int = 16, skips=(4,)):
    super().__init__()
    self.num_freqs, self.skips = num_freqs, tuple(skips)
    in_ch = 4 * (2 * num_freqs + 1)
    self.pts_linears = nn.ModuleList(
        [nn.Linear(in_ch, width)]
        + [nn.Linear(width + (in_ch if i - 1 in self.skips else 0), width)
           for i in range(1, depth)])
    self.coeff_linear = nn.Linear(width, num_basis * 3)
    nn.init.zeros_(self.coeff_linear.weight)
    nn.init.zeros_(self.coeff_linear.bias)

  def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> DCT coefficients [..., 3 * num_basis]."""
    inputs = periodic_embed(xyzt, self.num_freqs, self.num_freqs,
                            linspace=True)
    h = inputs
    for i, layer in enumerate(self.pts_linears):
      h = F.relu(layer(h))
      if i in self.skips:
        h = torch.cat([inputs, h], dim=-1)
    return self.coeff_linear(h)
