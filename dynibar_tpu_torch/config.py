"""Render and training settings of the forward-facing (FF) and monocular
(mono) models.

``RenderSettings`` copies the fields of ``dynibar_tpu``'s
``RenderSettings`` that the port's renders read (the FF eval render, the
FF fine-stage and the mono train steps), with the JAX names.  The TPU-only
layout switches (strip sampling, the channel-major handoff, fused RGB
sampling) have no counterpart: the CUDA sampler is exact for every sample.
``mono_render_settings`` is the mono branch of ``DynibarConfig
.render_settings`` (dynibar_tpu/config.py:225-265).  ``TrainSettings``
copies the ``DynibarConfig`` fields that the trainers and the loss
schedule read, with the same defaults.
"""

from __future__ import annotations

import dataclasses

# the aggregator backward routes the CUDA kernels implement, per aggregator
# (the JAX names of dynibar_tpu/config.py:173,182)
DYNAMIC_BWD_ROUTES = ("pallas_split",)
STATIC_BWD_ROUTES = ("pallas_split", "pallas_split3")
# where the routes the port does not have yet are planned
_ROUTE_PLAN = {
    "pallas": "ROADMAP.md queue 2 (K3p/K4s, the single-kernel dynamic "
              "backward)",
    "flax": "no ROADMAP item: the port's twins are the plain modules, "
            "run with kernels=False"}


def check_route(field: str, value: str, allowed) -> None:
  if value not in allowed:
    raise NotImplementedError(
        f"{field}={value!r}: the port implements {allowed}; planned: "
        f"{_ROUTE_PLAN.get(value, 'nowhere (unknown route)')}")


@dataclasses.dataclass(frozen=True)
class RenderSettings:
  n_samples: int = 64
  n_importance: int = 0
  num_views_dy: int = 7
  # anchor (cross-time) views of the train steps; the eval render reads none
  num_views_anchor: int = 10
  num_views_static: int = 11
  # virtual source views of the mono batch (reference num_vv)
  num_vv: int = 0
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
  # the aggregators' training backward on the card: dynamic
  # "pallas_split" (K4a + K4b); static "pallas_split" (K5a + K5b) or
  # "pallas_split3" (K5a + K5c + K5d).  Any other value raises.
  fused_bwd_impl: str = "pallas_split"
  fused_st_bwd_impl: str = "pallas_split"

  def __post_init__(self):
    check_route("fused_bwd_impl", self.fused_bwd_impl, DYNAMIC_BWD_ROUTES)
    check_route("fused_st_bwd_impl", self.fused_st_bwd_impl,
                 STATIC_BWD_ROUTES)

  @property
  def num_offsets(self) -> int:
    return 2 * self.traj_window + 1


def mono_render_settings(num_source_views: int = 7, num_vv: int = 3,
                         **kw) -> RenderSettings:
  """The mono model's settings (``DynibarConfig.render_settings("mono")``):
  6 + num_vv dynamic views, 7 + num_vv anchor views (up to 6 real, an
  occasional identity view and the virtual ones), 2 · num_source_views
  static views and no importance stage.  ``kw`` sets the other fields."""
  return RenderSettings(num_views_dy=6 + num_vv,
                        num_views_anchor=7 + num_vv,
                        num_views_static=2 * num_source_views,
                        num_vv=num_vv, n_importance=0, **kw)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
  # optimizer (reference model.py:106-118, :341-351, train.py:469-471)
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
