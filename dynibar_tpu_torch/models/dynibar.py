"""The forward-facing (Nvidia benchmark) model container.

``FFModel`` holds the frozen-coarse and fine static/dynamic aggregators,
two motion MLPs, two feature nets and two DCT bases (reference
model.py:33-159).  Its state_dict keys are the JAX params pytree's
top-level names (``net_coarse_st``, ``feature_net_fine``, ``traj_basis``,
...), so ``utils/convert.py`` maps one onto the other.  ``apply_*`` go
through the kernel wrappers (CUDA kernels for CUDA tensors, plain twins on
CPU) unless ``kernels=False`` asks for the plain modules.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.core.motion import init_dct_basis
from dynibar_tpu_torch.models.aggregators import (DynamicAggregator,
                                                  StaticAggregator)
from dynibar_tpu_torch.models.feature_net import FeatureNet
from dynibar_tpu_torch.models.motion_mlp import MotionMLP
from dynibar_tpu_torch.ops.agg import (fused_dynamic_aggregator,
                                       fused_static_aggregator)
from dynibar_tpu_torch.utils.device import DeviceLike, resolve_device


class FFModel(nn.Module):

  def __init__(self, cfg: RenderSettings, num_frames: int,
               device: DeviceLike = None, seed: int = 0):
    """Random weights from `seed`; `device` None means the CUDA card."""
    super().__init__()
    dev = resolve_device(device)
    self.cfg, self.num_frames = cfg, num_frames
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(seed)
      for prefix, fine in (("coarse", False), ("fine", True)):
        n_total = cfg.n_samples + (cfg.n_importance if fine else 0)
        feat = cfg.fine_feat_dim if fine else cfg.coarse_feat_dim
        setattr(self, f"net_{prefix}_st", StaticAggregator(
            feat, n_total, cfg.anti_alias_pooling, cfg.mask_rgb))
        setattr(self, f"net_{prefix}_dy",
                DynamicAggregator(feat, n_total, shift=0.0))
      self.motion_mlp = MotionMLP(cfg.num_basis)
      self.motion_mlp_fine = MotionMLP(cfg.num_basis)
      self.feature_net = FeatureNet(cfg.coarse_feat_dim, cfg.fine_feat_dim)
      self.feature_net_fine = FeatureNet(cfg.coarse_feat_dim,
                                         cfg.fine_feat_dim)
    basis = torch.from_numpy(init_dct_basis(cfg.num_basis, num_frames))
    self.traj_basis = nn.Parameter(basis.clone())
    self.traj_basis_fine = nn.Parameter(basis.clone())
    self.requires_grad_(False)
    self.eval()
    self.to(dev)

  @property
  def device(self) -> torch.device:
    return self.traj_basis.device

  def apply_dy(self, stage: str, pts, rgb_feat, ray_dir, mask, time,
               kernels: bool = True):
    net = getattr(self, f"net_{stage}_dy")
    if kernels:
      return fused_dynamic_aggregator(net, pts, rgb_feat, ray_dir, mask, time)
    return net(pts, rgb_feat, ray_dir, mask, time)

  def apply_st(self, stage: str, pts, ref_pl, src_pl, rgb_feat, ray_diff,
               mask, kernels: bool = True):
    net = getattr(self, f"net_{stage}_st")
    args = (pts, ref_pl, src_pl, rgb_feat, ray_diff, mask)
    return fused_static_aggregator(net, *args) if kernels else net(*args)

  def apply_motion(self, stage: str, xyzt: torch.Tensor) -> torch.Tensor:
    return (self.motion_mlp_fine if stage == "fine" else self.motion_mlp)(xyzt)

  def basis(self, stage: str) -> torch.Tensor:
    return self.traj_basis_fine if stage == "fine" else self.traj_basis

  def encode_featmaps(self, src_rgbs: torch.Tensor,
                      static_src_rgbs: torch.Tensor) -> Tuple[tuple, tuple]:
    """(coarse, fine) featmap triples (dynamic, anchor=None, static) as the
    reference eval routes them (eval_nvidia.py:335-358): dynamic <- coarse
    channels, static <- fine channels of each stage's feature net."""
    out = []
    for net in (self.feature_net, self.feature_net_fine):
      out.append((net(src_rgbs)[0], None, net(static_src_rgbs)[1]))
    return out[0], out[1]
