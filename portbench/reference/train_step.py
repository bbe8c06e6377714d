"""The reference's mono and FF train steps: loss, autograd, Adam.

Written for the benchmark after dynibar_tpu_torch/train/trainer.py
(commit a749e58): the loss closures (feature maps -> render -> the
8-term loss), plain ``torch.optim.Adam`` with one param group per model
group at the reference multipliers (google/dynibar model.py:341-351 for
the mono model, :106-118 for the FF fine stage) and the capped StepLR.
No clip: the benchmark's configurations set none.

``step(..., chunks=n)`` runs one step over n slices of the rays in turn,
as the port's mesh splits a step over n ranks (parallel/mesh.py), so
that a step too large for one card's memory in f32 still runs: a first
pass without autograd sums each loss denominator over all the slices,
then each slice renders its rows (its rows of the one global sample
draw, ``sampling.RowShard``) and backpropagates its share of the global
loss; the gradients add up to the whole batch's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.config import TrainSettings
from portbench.reference.losses import compute_ff_losses, compute_mono_losses
from portbench.reference.render_image import (RAY_SHARDED_AXIS1_KEYS,
                                              RAY_SHARDED_KEYS)
from portbench.reference.render_rays import render_rays_mono, render_rays_mv
from portbench.reference.sampling import RowShard


def mono_lrs(cfg: TrainSettings) -> Dict[str, float]:
  return {"net_coarse_st": cfg.lrate_mlp * 0.5,
          "feature_net_st": cfg.lrate_feature * 0.5,
          "net_coarse_dy": cfg.lrate_mlp,
          "feature_net": cfg.lrate_feature,
          "motion_mlp": cfg.lrate_mlp,
          "traj_basis": cfg.lrate_mlp * 0.25}


def ff_lrs(cfg: TrainSettings) -> Dict[str, float]:
  return {"net_fine_st": cfg.lrate_mlp * cfg.lr_multipler,
          "net_fine_dy": cfg.lrate_mlp,
          "feature_net_fine": cfg.lrate_feature,
          "motion_mlp_fine": cfg.lrate_mlp,
          "traj_basis_fine": cfg.lrate_mlp * 0.25}


class _Slices:
  """The mesh the losses see while one step runs slice by slice: in the
  first pass it records each slice's denominator sums, in the second it
  returns their totals over the slices."""

  def __init__(self, world: int):
    self.world, self.rank = world, 0
    self.recorded = [[] for _ in range(world)]
    self.totals = None
    self._next = 0

  def all_reduce(self, local: torch.Tensor) -> torch.Tensor:
    if self.totals is None:
      self.recorded[self.rank].append(local.detach().clone())
      return local
    out = self.totals[self._next]
    self._next += 1
    return out

  def start(self, rank: int) -> None:
    self.rank, self._next = rank, 0

  def close_first_pass(self) -> None:
    self.totals = [sum(parts) for parts in zip(*self.recorded)]


def _rows(rb, rank: int, world: int):
  """Slice ``rank`` of ``world`` of the batch's rays."""
  n = rb["ray_o"].shape[0] // world
  sl = slice(rank * n, (rank + 1) * n)
  return {k: (v[sl] if k in RAY_SHARDED_KEYS
              else v[:, sl] if k in RAY_SHARDED_AXIS1_KEYS else v)
          for k, v in rb.items()}


def _cap(first_lr: float, gamma: float, floor: float = 5e-7) -> int:
  if first_lr <= floor:
    return 0
  return int(math.ceil(math.log(floor / first_lr) / math.log(gamma)))


class ReferenceTrainer:
  """A model and its Adam; ``step`` runs one reference train step."""

  def __init__(self, model, cfg, train_cfg: TrainSettings, kind: str):
    self.model, self.cfg, self.tcfg, self.kind = model, cfg, train_cfg, kind
    lrs = mono_lrs(train_cfg) if kind == "mono" else ff_lrs(train_cfg)
    self.first_lr = next(iter(lrs.values()))
    groups = []
    for key, lr in lrs.items():
      mod = getattr(model, key)
      params = [mod] if key.startswith("traj_basis") else list(
          mod.parameters())
      groups.append({"params": params, "lr": lr, "base_lr": lr, "name": key})
    self.opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    self.steps = 0

  def _lr(self):
    gamma = self.tcfg.lrate_decay_factor
    cap = _cap(self.first_lr, gamma)
    n = min(self.steps // max(1, self.tcfg.lrate_decay_steps), cap)
    for g in self.opt.param_groups:
      g["lr"] = g["base_lr"] * gamma ** n

  def loss(self, rb, weights, generator, mesh=None):
    m = self.model
    if self.kind == "mono":
      featmaps = m.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"],
                                   rb["anchor_src_rgbs"])
      ret = render_rays_mono(m, rb, featmaps, self.cfg, device=m.device,
                             kernels=False, is_train=True, det=False,
                             generator=generator, needs_grad=True)
      return compute_mono_losses(ret, rb, weights, mesh)["loss"]
    coarse_fm, fine_fm = m.encode_featmaps(
        rb["src_rgbs"], rb["static_src_rgbs"], rb["anchor_src_rgbs"])
    ret = render_rays_mv(m, rb, coarse_fm, fine_fm, self.cfg,
                         device=m.device, kernels=False, is_train=True,
                         det=False, generator=generator)
    return compute_ff_losses(ret, rb, weights, mesh)["loss"]

  def _sliced_loss(self, rb, weights, generator, chunks: int) -> float:
    """The step's loss backpropagated slice by slice; returns the loss."""
    state = generator.get_state()
    slices = _Slices(chunks)
    with torch.no_grad():
      for k in range(chunks):
        slices.start(k)
        generator.set_state(state)
        self.loss(_rows(rb, k, chunks), weights,
                  RowShard(generator, k, chunks), slices)
    slices.close_first_pass()
    total = 0.0
    for k in range(chunks):
      slices.start(k)
      generator.set_state(state)
      part = self.loss(_rows(rb, k, chunks), weights,
                       RowShard(generator, k, chunks), slices)
      part.backward()
      total += float(part.detach())
    return total

  def step(self, rb, weights, generator, chunks: int = 1):
    """One step; returns the loss and each trained leaf's gradient."""
    self.opt.zero_grad(set_to_none=True)
    if chunks > 1:
      loss = torch.tensor(self._sliced_loss(rb, weights, generator, chunks))
    else:
      loss = self.loss(rb, weights, generator)
      loss.backward()
    grads = {}
    for g in self.opt.param_groups:
      for p in g["params"]:
        grads[id(p)] = None if p.grad is None else p.grad.detach().clone()
    self._lr()
    self.opt.step()
    self.steps += 1
    return float(loss.detach()), grads
