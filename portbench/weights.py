"""Model weights made by the benchmark from the seed, on the device.

One ``torch.rand`` call on the card (a ``torch.Generator`` seeded from
``--seed``) fills every leaf at once; each leaf takes its slice through
an affine map: a weight matrix or kernel uniform in ±1/sqrt(fan_in) (the
scale of PyTorch's default init), a bias in the same range as its
layer's weight, a norm's scale 1 ± 0.1 and its shift ±0.1.  The motion
MLP's output layer (zero at the program's init) takes a tenth of its
range, so the trajectories start small but every leaf has a gradient.
Scalars and the DCT trajectory bases keep the reference module's
deterministic values.  Program and reference load the same tensors.
"""

from __future__ import annotations

import collections
from typing import Dict

import torch


def make_weights(template: torch.nn.Module, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
  """A state_dict with ``template``'s names and shapes, from ``seed``."""
  sd = template.state_dict()
  total = sum(v.numel() for v in sd.values())
  gen = torch.Generator(device=device).manual_seed(seed)
  flat = torch.rand(total, generator=gen, device=device,
                    dtype=torch.float32) * 2.0 - 1.0
  out = collections.OrderedDict()
  off = 0
  for name, ref in sd.items():
    n = ref.numel()
    u = flat[off:off + n].view(ref.shape)
    off += n
    base = name.rsplit(".", 1)[0]
    weight = sd.get(base + ".weight")
    if ref.dim() == 0 or name.startswith("traj_basis"):
      val = ref.to(device=device, dtype=torch.float32).clone()
    elif ref.dim() >= 2:
      val = u / float(ref[0].numel()) ** 0.5
    elif name.endswith(".bias") and weight is not None and weight.dim() >= 2:
      val = u / float(weight[0].numel()) ** 0.5
    elif name.endswith(".weight"):
      val = 1.0 + 0.1 * u
    else:
      val = 0.1 * u
    if "coeff_linear" in name:
      val = 0.1 * val
    out[name] = val.contiguous()
  return out
