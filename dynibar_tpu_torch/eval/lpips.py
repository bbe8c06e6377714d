"""LPIPS perceptual metric (AlexNet backbone).

Port of ``dynibar_tpu.eval.lpips`` (which replaces the reference's NSFF
``models.PerceptualLoss``, eval_nvidia.py:16,289-291): torchvision
AlexNet's conv features at 5 stages, channel-unit normalised, their
squared difference weighted by learned 1×1 "lin" layers, averaged over
space (under a mask) and summed over stages.  The convolutions are plain
PyTorch (cuDNN on the card, TF32 off).

Weights are not in the repository: :func:`load_torch_lpips` reads the
``lpips`` package's lin weights (``alex.pth``) and torchvision's AlexNet
(``alexnet.pth``).  Without them :class:`LPIPSMetric` returns None, so
eval tables show NaN instead of a number.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dynibar_tpu_torch.utils.device import DeviceLike, resolve_device

# AlexNet "features": (out channels, kernel, stride, padding) per conv,
# 3/2 max-pools after stages 0 and 1, as in torchvision
_ALEX_STAGES = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
                (256, 3, 1, 1), (256, 3, 1, 1))
# torchvision's indices of those convs in AlexNet.features
_CONV_IDX = (0, 3, 6, 8, 10)
# the ImageNet shift / scale of the lpips module
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _nearest(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """``jax.image.resize(mask, (B, h, w, 1), "nearest")`` of [B, H, W, 1]:
  source index floor((i + 0.5) * in / out) in f32, the half-pixel rule
  of ``F.interpolate(mode="nearest-exact")``."""
  def index(n_in: int, n_out: int) -> torch.Tensor:
    pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
    return pos.floor().long().to(mask.device)

  if mask.shape[1] != h:
    mask = mask[:, index(mask.shape[1], h)]
  if mask.shape[2] != w:
    mask = mask[:, :, index(mask.shape[2], w)]
  return mask


class LPIPSNet(nn.Module):
  """Full LPIPS: normalise the inputs, diff the unit-normalised features,
  weight by the lin heads."""

  def __init__(self):
    super().__init__()
    self.alex = nn.Module()
    cin = 3
    for i, (ch, k, s, p) in enumerate(_ALEX_STAGES):
      setattr(self.alex, f"conv{i}", nn.Conv2d(cin, ch, k, s, p))
      setattr(self, f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
      cin = ch
    self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                         persistent=False)
    self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                         persistent=False)

  def features(self, x: torch.Tensor):
    outs = []
    for i in range(len(_ALEX_STAGES)):
      x = F.relu(getattr(self.alex, f"conv{i}")(x))
      outs.append(x)
      if i in (0, 1):
        x = F.max_pool2d(x, 3, 2)
    return outs

  def forward(self, img0: torch.Tensor, img1: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """img0 / img1 [B, H, W, 3] in [-1, 1]; mask [B, H, W, 1] or None;
    returns [B]."""
    f0 = self.features((img0.permute(0, 3, 1, 2) - self.shift) / self.scale)
    f1 = self.features((img1.permute(0, 3, 1, 2) - self.shift) / self.scale)
    total = 0.0
    for i, (a, b) in enumerate(zip(f0, f1)):
      a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
      b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
      wd = getattr(self, f"lin{i}")((a - b) ** 2).permute(0, 2, 3, 1)
      if mask is None:
        total = total + wd.mean(dim=(1, 2, 3))
      else:
        m = _nearest(mask, wd.shape[1], wd.shape[2])
        total = total + ((wd * m).sum(dim=(1, 2, 3))
                         / (m.sum(dim=(1, 2, 3)) + 1e-8))
    return total


def load_torch_lpips(lpips_pth: str, alexnet_pth: str
                     ) -> Dict[str, torch.Tensor]:
  """The lpips package's lin weights + torchvision's AlexNet -> an
  ``LPIPSNet`` state_dict (both files are torch pickles, read in full as
  the JAX package reads them)."""
  lin_sd = torch.load(lpips_pth, map_location="cpu", weights_only=False)
  alex_sd = torch.load(alexnet_pth, map_location="cpu", weights_only=False)
  if hasattr(alex_sd, "state_dict"):
    alex_sd = alex_sd.state_dict()
  sd = {}
  for i, ti in enumerate(_CONV_IDX):
    sd[f"alex.conv{i}.weight"] = alex_sd[f"features.{ti}.weight"]
    sd[f"alex.conv{i}.bias"] = alex_sd[f"features.{ti}.bias"]
  for i in range(len(_ALEX_STAGES)):
    key = f"lin{i}.model.1.weight"
    if key not in lin_sd:
      key = f"lins.{i}.model.1.weight"
    sd[f"lin{i}.weight"] = lin_sd[key]
  return {k: torch.as_tensor(v).float() for k, v in sd.items()}


class LPIPSMetric:
  """Callable masked LPIPS; returns None when the weights are missing."""

  def __init__(self, weights_dir: Optional[str] = None,
               device: DeviceLike = None):
    self.net = None
    if weights_dir:
      lpips_pth = os.path.join(weights_dir, "alex.pth")
      alex_pth = os.path.join(weights_dir, "alexnet.pth")
      if os.path.exists(lpips_pth) and os.path.exists(alex_pth):
        net = LPIPSNet()
        net.load_state_dict(load_torch_lpips(lpips_pth, alex_pth))
        self.net = net.eval().requires_grad_(False).to(
            resolve_device(device))

  @property
  def available(self) -> bool:
    return self.net is not None

  def __call__(self, img0: np.ndarray, img1: np.ndarray,
               mask: Optional[np.ndarray] = None) -> Optional[float]:
    """img0 / img1 [H, W, 3] in [0, 1]; mask [H, W] or [H, W, C]."""
    if self.net is None:
      return None
    dev = self.net.shift.device

    def batch(x):
      return torch.as_tensor(np.asarray(x, np.float32), device=dev)[None]

    a, b = batch(img0 * 2.0 - 1.0), batch(img1 * 2.0 - 1.0)
    if mask is None:
      m = torch.ones(a.shape[:3] + (1,), device=dev)
    else:
      m = np.asarray(mask)
      m = batch(m[..., :1] if m.ndim == 3 else m[..., None])
    with torch.no_grad():
      return float(self.net(a, b, m)[0])
