"""Small building blocks, named and initialized like google/dynibar's.

``nn.Linear`` / ``nn.Conv2d`` already initialize as the reference relies on
(kaiming_uniform(a=√5) kernels, U(±1/√fan_in) biases), so MLPs are plain
``nn.Sequential`` stacks: the reference's parameter names
(``base_fc.0.weight``, ``base_fc.2.weight``, ...) follow from the indices.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn


def mlp(in_dim: int, features: Sequence[int], activate_final: bool = False
        ) -> nn.Sequential:
  """Linear layers with ELU between them (and after the last if asked)."""
  layers = []
  for i, f in enumerate(features):
    layers.append(nn.Linear(in_dim, f))
    if i < len(features) - 1 or activate_final:
      layers.append(nn.ELU())
    in_dim = f
  return nn.Sequential(*layers)


def linear_layers(seq: nn.Sequential):
  """The nn.Linear members of an mlp(), in order."""
  return [m for m in seq if isinstance(m, nn.Linear)]


def conv(cin: int, cout: int, k: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
  """Conv2d with reflect padding (reference feature_network.py)."""
  return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=bias,
                   padding_mode="reflect")


def instance_norm(c: int) -> nn.InstanceNorm2d:
  return nn.InstanceNorm2d(c, affine=True, track_running_stats=False)
