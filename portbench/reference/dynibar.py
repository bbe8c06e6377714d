"""Frozen copy of dynibar_tpu_torch/models/dynibar.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

The model containers: forward-facing (FF) and monocular (mono).

``FFModel`` holds the frozen-coarse and fine static/dynamic aggregators,
two motion MLPs, two feature nets and two DCT bases (reference
model.py:33-159).  Its state_dict keys are the JAX params pytree's
top-level names (``net_coarse_st``, ``feature_net_fine``, ``traj_basis``,
...), so ``utils/convert.py`` maps one onto the other.  ``apply_*`` go
through the kernel wrappers (CUDA kernels for CUDA tensors, plain twins on
CPU; with grad enabled the kernels' autograd Functions) unless
``kernels=False`` asks for the plain f32 modules or ``kernels=BF16_TWIN``
for their bf16 twin (``utils/kernel_check.bf16_twin``: the module under
autocast around the aggregator call alone, the counterpart of the JAX
package's flax aggregators at ``compute_dtype="bfloat16"`` with
``fused_aggregators=False``).  ``train_fine()`` is the
fine-stage training mode: only the fine groups require grad, the coarse
stage stays frozen (reference model.py:106-118).  ``train_coarse()`` is
the coarse-stage mode that produces that frozen stage
(dynibar_tpu/train/trainer.py:193-254): only the coarse groups require
grad.  ``param_groups()`` follows the mode.

``MonoModel`` holds one static and one dynamic aggregator (the dynamic one
with ``shift = 5``), two feature nets, one motion MLP and one DCT basis
(reference model.py:291-397, dynibar_tpu/models/dynibar.py:64-193), under
the JAX top-level names.  It has one stage: its ``apply_*`` take the
stage argument of ``FFModel``'s as ``None``, so the render code serves
both.  Both containers hand the aggregators' backward routes
(``cfg.fused_st_bwd_impl``, ``cfg.fused_bwd_impl``) to the kernel
wrappers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.utils.checkpoint

from portbench.reference.config import RenderSettings
from portbench.reference.motion import init_dct_basis
from portbench.reference.aggregators import (DynamicAggregator,
                                                  StaticAggregator)
from portbench.reference.feature_net import FeatureNet
from portbench.reference.motion_mlp import MotionMLP
from portbench.reference.device import DeviceLike, resolve_device
from portbench.reference import precision

# what a render's aggregators (and its no-grad sampler) run: True the CUDA
# kernels (K1-K3, their plain twins on the CPU), False the f32 modules and
# F.grid_sample, BF16_TWIN the modules' bf16 twin and F.grid_sample
BF16_TWIN = "bf16_twin"
Kernels = Union[bool, str]


def launches_kernels(kernels: Kernels) -> bool:
  """Whether ``kernels`` asks for the CUDA kernels."""
  if kernels not in (True, False, BF16_TWIN):
    raise ValueError(f"kernels={kernels!r}: True, False or {BF16_TWIN!r}")
  return kernels != BF16_TWIN and bool(kernels)


def _hooked_call(net: nn.Module, *args) -> torch.Tensor:
  with precision.hooked(net):
    return net(*args)


def aggregate(net: nn.Module, static: bool, args, kernels: Kernels,
              bwd: str) -> torch.Tensor:
  """One aggregator call: the plain module, whatever ``kernels`` says (the
  reference has no kernels; the control's lower precision rounds the
  module's inputs through ``precision.hooked``).  Under autograd the
  module's activations are recomputed in the backward
  (``torch.utils.checkpoint``), so that a whole train step of the plain
  f32 modules fits on one card; the gradients are the same."""
  if torch.is_grad_enabled():
    return torch.utils.checkpoint.checkpoint(_hooked_call, net, *args,
                                             use_reentrant=False)
  return _hooked_call(net, *args)

# the groups the fine-stage train step updates, and the frozen coarse stage
# (dynibar_tpu/train/trainer.py:94-120, :189-190)
FF_FINE_KEYS = ("net_fine_st", "net_fine_dy", "feature_net_fine",
                "motion_mlp_fine", "traj_basis_fine")
FF_COARSE_KEYS = ("net_coarse_st", "net_coarse_dy", "feature_net",
                  "motion_mlp", "traj_basis")
# the mono step's groups, in the optimizer order of reference
# model.py:341-351 (dynibar_tpu/train/trainer.py:73-80)
MONO_KEYS = ("net_coarse_st", "feature_net_st", "net_coarse_dy",
             "feature_net", "motion_mlp", "traj_basis")


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
    self.trained_keys = FF_FINE_KEYS
    self.requires_grad_(False)
    self.eval()
    self.to(dev)

  @property
  def device(self) -> torch.device:
    return self.traj_basis.device

  def apply_dy(self, stage: str, pts, rgb_feat, ray_dir, mask, time,
               kernels: Kernels = True):
    return aggregate(getattr(self, f"net_{stage}_dy"), False,
                     (pts, rgb_feat, ray_dir, mask, time), kernels,
                     self.cfg.fused_bwd_impl)

  def apply_st(self, stage: str, pts, ref_pl, src_pl, rgb_feat, ray_diff,
               mask, kernels: Kernels = True):
    return aggregate(getattr(self, f"net_{stage}_st"), True,
                     (pts, ref_pl, src_pl, rgb_feat, ray_diff, mask), kernels,
                     self.cfg.fused_st_bwd_impl)

  def apply_motion(self, stage: str, xyzt: torch.Tensor) -> torch.Tensor:
    return (self.motion_mlp_fine if stage == "fine" else self.motion_mlp)(xyzt)

  def basis(self, stage: str) -> torch.Tensor:
    return self.traj_basis_fine if stage == "fine" else self.traj_basis

  def _train(self, keys) -> "FFModel":
    self.trained_keys = keys
    self.requires_grad_(False)
    for key in keys:
      getattr(self, key).requires_grad_(True)
    return self

  def train_fine(self) -> "FFModel":
    """Fine-stage training mode: the fine groups require grad, the coarse
    groups stay frozen."""
    return self._train(FF_FINE_KEYS)

  def train_coarse(self) -> "FFModel":
    """Coarse-stage training mode: the coarse groups require grad, the
    fine groups stay frozen."""
    return self._train(FF_COARSE_KEYS)

  def param_groups(self) -> Dict[str, List[nn.Parameter]]:
    """The trained groups' parameters, by group name: the fine groups
    unless ``train_coarse()`` chose the coarse ones."""
    return {key: ([getattr(self, key)] if key.startswith("traj_basis")
                  else list(getattr(self, key).parameters()))
            for key in self.trained_keys}

  def encode_featmaps(self, src_rgbs: torch.Tensor,
                      static_src_rgbs: torch.Tensor,
                      anchor_src_rgbs: Optional[torch.Tensor] = None,
                      fine_static_src_rgbs: Optional[torch.Tensor] = None
                      ) -> Tuple[tuple, tuple]:
    """(coarse, fine) featmap triples (dynamic, anchor, static) as the
    reference eval routes them (eval_nvidia.py:335-358): dynamic <- coarse
    channels, static <- fine channels of each stage's feature net; no
    anchor maps.  ``fine_static_src_rgbs`` gives the fine stage other
    static sources than the coarse stage's: the eval's ``mask_static``
    hides the moving regions from the fine stage alone
    (dynibar_tpu/eval/nvidia_eval.py:81-93).  With ``anchor_src_rgbs``
    the training routing of ``compute_ff_featmaps`` (trainer.py:291-310):
    the coarse maps without autograd, and fine anchor maps from
    feature_net_fine's coarse channels."""
    with torch.set_grad_enabled(anchor_src_rgbs is None
                                and torch.is_grad_enabled()):
      net = self.feature_net
      coarse = (net(src_rgbs)[0], None, net(static_src_rgbs)[1])
    net = self.feature_net_fine
    anchor = None if anchor_src_rgbs is None else net(anchor_src_rgbs)[0]
    fine_static = (static_src_rgbs if fine_static_src_rgbs is None
                   else fine_static_src_rgbs)
    return coarse, (net(src_rgbs)[0], anchor, net(fine_static)[1])

  def encode_coarse_featmaps(self, src_rgbs: torch.Tensor,
                             static_src_rgbs: torch.Tensor,
                             anchor_src_rgbs: Optional[torch.Tensor] = None
                             ) -> tuple:
    """The coarse stage's (dynamic, anchor or None, static) featmaps for
    its own training (``compute_ff_coarse_featmaps``, dynibar_tpu/train/
    trainer.py:223-235), recorded when grad is enabled: dynamic and anchor
    maps from feature_net's coarse channels, static maps from its fine
    channels, as the eval routes the coarse stage."""
    net = self.feature_net
    anchor = None if anchor_src_rgbs is None else net(anchor_src_rgbs)[0]
    return (net(src_rgbs)[0], anchor, net(static_src_rgbs)[1])


class MonoModel(nn.Module):

  def __init__(self, cfg: RenderSettings, num_frames: int,
               device: DeviceLike = None, seed: int = 0,
               dy_shift: float = 5.0):
    """Random weights from `seed`; `device` None means the CUDA card.
    dy_shift: the dynamic sigma shift (reference model.py:307)."""
    super().__init__()
    dev = resolve_device(device)
    self.cfg, self.num_frames = cfg, num_frames
    feat = cfg.coarse_feat_dim
    with torch.random.fork_rng(devices=[]):
      torch.manual_seed(seed)
      self.net_coarse_st = StaticAggregator(
          feat, cfg.n_samples, cfg.anti_alias_pooling, cfg.mask_rgb)
      self.net_coarse_dy = DynamicAggregator(feat, cfg.n_samples,
                                             shift=dy_shift)
      self.feature_net = FeatureNet(cfg.coarse_feat_dim, cfg.fine_feat_dim)
      self.feature_net_st = FeatureNet(cfg.coarse_feat_dim,
                                       cfg.fine_feat_dim)
      self.motion_mlp = MotionMLP(cfg.num_basis)
    self.traj_basis = nn.Parameter(
        torch.from_numpy(init_dct_basis(cfg.num_basis, num_frames)))
    self.requires_grad_(False)
    self.eval()
    self.to(dev)

  @property
  def device(self) -> torch.device:
    return self.traj_basis.device

  # `stage` is FFModel's argument: the mono model has one stage (None)
  def apply_dy(self, stage: Optional[str], pts, rgb_feat, ray_dir, mask,
               time, kernels: Kernels = True):
    return aggregate(self.net_coarse_dy, False,
                     (pts, rgb_feat, ray_dir, mask, time), kernels,
                     self.cfg.fused_bwd_impl)

  def apply_st(self, stage: Optional[str], pts, ref_pl, src_pl, rgb_feat,
               ray_diff, mask, kernels: Kernels = True):
    return aggregate(self.net_coarse_st, True,
                     (pts, ref_pl, src_pl, rgb_feat, ray_diff, mask), kernels,
                     self.cfg.fused_st_bwd_impl)

  def apply_motion(self, stage: Optional[str], xyzt: torch.Tensor
                   ) -> torch.Tensor:
    return self.motion_mlp(xyzt)

  def basis(self, stage: Optional[str]) -> torch.Tensor:
    return self.traj_basis

  def train_all(self) -> "MonoModel":
    """Training mode of the mono step: every group requires grad."""
    self.requires_grad_(True)
    return self

  def param_groups(self) -> Dict[str, List[nn.Parameter]]:
    """Every group's parameters, by group name, in optimizer order."""
    return {key: ([self.traj_basis] if key == "traj_basis"
                  else list(getattr(self, key).parameters()))
            for key in MONO_KEYS}

  def encode_featmaps(self, src_rgbs: torch.Tensor,
                      static_src_rgbs: torch.Tensor,
                      anchor_src_rgbs: Optional[torch.Tensor] = None
                      ) -> tuple:
    """(dynamic, anchor or None, static) featmaps as ``compute_featmaps``
    routes them (dynibar_tpu/train/trainer.py:132-141): the dynamic and
    anchor maps from feature_net's coarse channels, the static maps from
    feature_net_st's coarse channels."""
    net = self.feature_net
    anchor = None if anchor_src_rgbs is None else net(anchor_src_rgbs)[0]
    return (net(src_rgbs)[0], anchor, self.feature_net_st(static_src_rgbs)[0])
