"""Render and training settings of the forward-facing (FF) model.

``RenderSettings`` copies the fields of ``dynibar_tpu``'s
``RenderSettings`` that the FF render reads (eval and the fine-stage
train step).  The TPU-only layout switches (strip sampling, the
channel-major handoff, fused RGB sampling) have no counterpart: the CUDA
sampler is exact for every sample.  ``TrainSettings`` copies the
``DynibarConfig`` fields that the FF trainer and the loss schedule read,
with the same defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
  n_samples: int = 64
  n_importance: int = 0
  num_views_dy: int = 7
  # anchor (cross-time) views of the train step; the eval render reads none
  num_views_anchor: int = 10
  num_views_static: int = 11
  num_basis: int = 6
  inv_uniform: bool = False
  # disocclusion weights of the cycle loss: 0 mix, 1 composite-dy, 2 full
  occ_weights_mode: int = 0
  anti_alias_pooling: bool = True
  mask_rgb: bool = True
  coarse_feat_dim: int = 32
  fine_feat_dim: int = 32
  # trajectory offsets window [-3..3] (reference render_ray.py:971)
  traj_window: int = 3
  # "float32" or "bfloat16": bf16 samples the source images and feature
  # maps in bf16; geometry stays f32 either way.  The CUDA aggregator
  # kernels always take bf16 operands with f32 accumulation.
  compute_dtype: str = "float32"

  @property
  def num_offsets(self) -> int:
    return 2 * self.traj_window + 1


@dataclasses.dataclass(frozen=True)
class TrainSettings:
  # optimizer (reference model.py:106-118, train.py:469-471)
  lrate_mlp: float = 5e-4
  lrate_feature: float = 1e-3
  lr_multipler: float = 1.0
  lrate_decay_factor: float = 0.5
  lrate_decay_steps: int = 50000
  clip_grad_norm: float = 0.0
  # loss weights and their decay (reference train.py:302-445)
  w_disp: float = 5e-2
  w_flow: float = 5e-3
  w_cycle: float = 0.1
  cycle_factor: float = 0.1
  anneal_cycle: bool = False
  w_reg: float = 0.05
  w_skew_entropy: float = 1e-3
  w_distortion: float = 1e-3
  decay_rate: float = 10.0
  init_decay_epoch: int = 150
