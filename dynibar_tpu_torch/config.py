"""Render settings of the FF eval slice.

A copy of the fields of ``dynibar_tpu``'s ``RenderSettings`` that the
forward-facing eval render reads.  The TPU-only layout switches (strip
sampling, the channel-major handoff, fused RGB sampling) have no
counterpart: the CUDA sampler is exact for every sample.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
  n_samples: int = 64
  n_importance: int = 0
  num_views_dy: int = 7
  num_views_static: int = 11
  num_basis: int = 6
  inv_uniform: bool = False
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
