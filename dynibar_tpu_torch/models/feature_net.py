"""2D feature extractor: the live path of the reference ``ResNet``
(ibrnet/feature_network.py:179-311).

conv1 (7×7, s2, reflect) → IN → ReLU → layer1 (three BasicBlocks, the
first strided with a 1×1 downsample) → 1×1 out_conv → channel split into
(coarse, fine) maps at 1/4 resolution.  The reference's layer2/3 and
decoder never run and are not built.  Public layout is NHWC like the JAX
package; the convolutions run NCHW through cuDNN with TF32 off.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynibar_tpu_torch.models.nn_layers import conv, instance_norm


class BasicBlock(nn.Module):
  """Reference feature_network.py:41-84 with InstanceNorm + reflect pad."""

  def __init__(self, cin: int, planes: int, stride: int = 1):
    super().__init__()
    self.conv1 = conv(cin, planes, 3, stride)
    self.bn1 = instance_norm(planes)
    self.conv2 = conv(planes, planes, 3, 1)
    self.bn2 = instance_norm(planes)
    self.downsample = None
    if stride != 1 or cin != planes:
      self.downsample = nn.Sequential(conv(cin, planes, 1, stride),
                                      instance_norm(planes))

  def forward(self, x):
    identity = x if self.downsample is None else self.downsample(x)
    out = F.relu(self.bn1(self.conv1(x)))
    out = self.bn2(self.conv2(out))
    return F.relu(out + identity)


class FeatureNet(nn.Module):

  def __init__(self, coarse_out_ch: int = 32, fine_out_ch: int = 32):
    super().__init__()
    self.coarse_out_ch, self.fine_out_ch = coarse_out_ch, fine_out_ch
    self.conv1 = conv(3, 64, 7, 2)
    self.bn1 = instance_norm(64)
    self.layer1 = nn.Sequential(BasicBlock(64, 64, 2), BasicBlock(64, 64, 1),
                                BasicBlock(64, 64, 1))
    self.out_conv = conv(64, coarse_out_ch + fine_out_ch, 1, bias=True)

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [V,H,W,3] in [0,1] -> ([V,H/4,W/4,Cc], [V,H/4,W/4,Cf]), NHWC."""
    x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
    x = self.out_conv(self.layer1(x)).permute(0, 2, 3, 1)
    return (x[..., :self.coarse_out_ch].contiguous(),
            x[..., -self.fine_out_ch:].contiguous())
