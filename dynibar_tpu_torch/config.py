"""Render and training settings of the forward-facing (FF) and monocular
(mono) models.

``RenderSettings`` copies the fields of ``dynibar_tpu``'s
``RenderSettings`` that the port's renders read (the FF eval render, the
FF fine-stage and the mono train steps), with the JAX names.  The TPU-only
layout switches (strip sampling, the channel-major handoff, fused RGB
sampling) have no counterpart: the CUDA sampler is exact for every sample.
``mono_render_settings`` is the mono branch of ``DynibarConfig
.render_settings`` (dynibar_tpu/config.py:225-265); its field
``mono_time_diff`` is read by no JAX render and has no counterpart.
``TrainSettings``
copies the ``DynibarConfig`` fields that the trainers and the loss
schedule read, with the same defaults.  ``DynibarConfig`` holds the
training and eval CLIs' knobs and reads the reference-style
``configs/*.txt`` and ``configs_nvidia/*.txt``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

# the aggregator backward routes the CUDA kernels implement, per aggregator
# (the JAX names of dynibar_tpu/config.py:173,182)
DYNAMIC_BWD_ROUTES = ("pallas_split", "pallas")
STATIC_BWD_ROUTES = ("pallas_split", "pallas_split3")
# where the routes the port does not have are planned
_ROUTE_PLAN = {
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
  # "pallas_split" (K3r forward, K4a + K4b) or "pallas" (K3p forward, the
  # single-kernel K4s); static "pallas_split" (K5a + K5b) or
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


def _parse_value(field_type, raw: str):
  raw = raw.strip()
  if field_type is bool:
    return raw.lower() in ("1", "true", "yes", "on")
  if field_type is int:
    return int(raw)
  if field_type is float:
    return float(raw)
  if field_type is list:
    return raw.split()
  return raw


_TYPES = {"bool": bool, "int": int, "float": float, "str": str,
          "List[str]": list}


# the training CLI's seeds: the initial weights and the steps' random
# draws, as the JAX CLI's PRNGKey(0) and PRNGKey(1)
INIT_SEED = 0
STEP_SEED = 1


@dataclasses.dataclass
class DynibarConfig:
  """The knobs of the monocular training and render CLIs (``cli/train``,
  ``cli/render_monocular``), the server (``serve/server``), the FF
  fine-stage training CLI (``cli/train_ff``) and the Nvidia eval CLI
  (``cli/eval_nvidia``), copied from
  ``dynibar_tpu.config.DynibarConfig`` with its names and defaults
  (reference config.py:6-375).  The TPU-only switches (strip sampling,
  fused RGB sampling, the channel-major handoff, buffer donation, remat,
  the fused-aggregator toggles) have no counterpart."""

  # general / paths
  rootdir: str = "./"
  folder_path: str = ""
  # the frozen coarse stage cli/train_ff grafts: a port run folder (its
  # newest snapshot) or a reference coarse .pth (reference model.py:102)
  coarse_dir: str = ""
  expname: str = "exp"
  workers: int = 4

  # data / masking options
  mask_src_view: bool = False
  mask_static: bool = False
  training_height: int = 288
  erosion_radius: int = 1

  # ray/batch options
  N_rand: int = 512
  sample_mode: str = "uniform"
  chunk_size: int = 1024

  # model options
  coarse_feat_dim: int = 32
  fine_feat_dim: int = 32
  num_source_views: int = 7
  num_basis: int = 6
  anti_alias_pooling: int = 1
  mask_rgb: int = 1
  num_vv: int = 3
  lr_multipler: float = 1.0

  # curriculum / schedules
  init_decay_epoch: int = 150
  max_range: int = 35
  decay_rate: float = 10.0
  cycle_factor: float = 0.1
  anneal_cycle: bool = False

  # datasets
  train_dataset: str = "monocular"
  train_scenes: List[str] = dataclasses.field(default_factory=list)
  eval_dataset: str = "llff_test"
  eval_scenes: List[str] = dataclasses.field(default_factory=list)
  render_idx: int = -1

  # checkpoints
  no_reload: bool = False
  ckpt_path: str = ""
  no_load_opt: bool = False

  # iterations & learning rates
  n_iters: int = 300000
  lrate_feature: float = 1e-3
  lrate_mlp: float = 5e-4
  lrate_decay_factor: float = 0.5
  lrate_decay_steps: int = 50000
  clip_grad_norm: float = 0.0

  # loss weights
  w_cycle: float = 0.1
  w_distortion: float = 1e-3
  w_disp: float = 5e-2
  w_flow: float = 5e-3
  w_skew_entropy: float = 1e-3
  w_reg: float = 0.05
  occ_weights_mode: int = 0

  # rendering options
  N_samples: int = 64
  N_importance: int = 64
  inv_uniform: bool = False

  # logging
  i_print: int = 100
  i_img: int = 1000
  i_weights: int = 10000

  # derived at run time (reference train.py:91-92)
  num_frames: int = 0

  # devices (parallel/mesh.py): under torchrun, one process per card;
  # "auto" is the launcher's world size and "N" must equal it.  Without a
  # launcher "auto" and "1" run on one card and a larger mesh raises.
  # The launcher's environment alone decides, so the JAX configs'
  # `distributed` (multi-host) key has no field: from_file skips it
  mesh_shape: str = "auto"
  compute_dtype: str = "float32"
  fused_bwd_impl: str = "pallas_split"
  fused_st_bwd_impl: str = "pallas_split"
  # cli/render_monocular: also assemble the rendered frames into an mp4
  # ("auto" = <out_dir>/video.mp4, "" = PNG frames only, like the reference)
  video_out: str = "auto"
  video_fps: float = 24.0

  @classmethod
  def from_file(cls, path: str, **overrides) -> "DynibarConfig":
    """Read a reference-style ``key = value`` config file; keys this class
    does not have are skipped, bare flags set booleans."""
    values = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    with open(path) as fh:
      for line in fh:
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
          if line in fields and fields[line].type == "bool":
            values[line] = True
          continue
        key, raw = (tok.strip() for tok in line.split("=", 1))
        if key in fields:
          values[key] = _parse_value(_TYPES.get(fields[key].type, str), raw)
    values.update(overrides)
    return cls(**values)

  def experiment_name(self) -> str:
    """Hyperparameters in the experiment name (reference train.py:50-57)."""
    return (
        f"{self.expname}_mr-{self.max_range}"
        f"_w-disp-{self.w_disp:.3f}_w-flow-{self.w_flow:.3f}"
        f"_anneal_cycle-{self.w_cycle:.1f}-{self.cycle_factor:.1f}"
        f"-w_mode-{self.occ_weights_mode}"
    )

  def out_folder(self) -> str:
    return os.path.join(self.rootdir, "out", self.experiment_name())

  def render_settings(self, mode: str = "mono") -> RenderSettings:
    """The render settings of the mono model ("mono"), the FF fine-stage
    training ("ff_train": 7 dynamic, 6 anchor, 11 static views) or the
    Nvidia benchmark eval ("ff": 7, 0, 11), as
    dynibar_tpu/config.py:222-254 builds them."""
    kw = dict(n_samples=self.N_samples, num_basis=self.num_basis,
              inv_uniform=self.inv_uniform,
              occ_weights_mode=self.occ_weights_mode,
              anti_alias_pooling=bool(self.anti_alias_pooling),
              mask_rgb=bool(self.mask_rgb),
              coarse_feat_dim=self.coarse_feat_dim,
              fine_feat_dim=self.fine_feat_dim,
              compute_dtype=self.compute_dtype,
              fused_bwd_impl=self.fused_bwd_impl,
              fused_st_bwd_impl=self.fused_st_bwd_impl)
    if mode == "mono":
      return mono_render_settings(num_source_views=self.num_source_views,
                                  num_vv=self.num_vv, **kw)
    if mode not in ("ff", "ff_train"):
      raise ValueError(f"render_settings({mode!r}): mono, ff or ff_train")
    return RenderSettings(n_importance=self.N_importance, num_views_dy=7,
                          num_views_anchor=6 if mode == "ff_train" else 0,
                          num_views_static=11, num_vv=0, **kw)

  def train_settings(self) -> TrainSettings:
    """The fields the optimizer and the loss schedule read."""
    names = {f.name for f in dataclasses.fields(TrainSettings)}
    return TrainSettings(**{k: getattr(self, k) for k in names})
