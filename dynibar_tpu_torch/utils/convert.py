"""The weight bridge: JAX ``FFModel`` / ``MonoModel`` params pytree <->
port state_dict.

Inverts ``dynibar_tpu/utils/torch_convert.py:73-149`` (feature net,
aggregators, motion MLP) and carries ``traj_basis`` / ``traj_basis_fine``
across.  One table of (pytree path, state_dict key, kind) drives both
directions, so the round trip is exact by construction.  Kinds:

  * ``linear``: flax kernel [in, out] <-> torch weight [out, in];
  * ``conv``: flax HWIO <-> torch OIHW;
  * ``copy``: biases, norm scales, the anti-alias scalar ``s``, bases.

This is the port's own copy of the name mapping: MLP ``dense_i`` is the
reference's Sequential index 2i (activations own no parameters), the
trunk lives under ``vis_pooling`` in the pytree and at top level in the
reference's names.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel

Entry = Tuple[Tuple[str, ...], str, str]


def _mlp(scope, prefix, n_layers) -> List[Entry]:
  out = []
  for i in range(n_layers):
    out.append((scope + (f"dense_{i}", "kernel"), f"{prefix}.{2 * i}.weight",
                "linear"))
    out.append((scope + (f"dense_{i}", "bias"), f"{prefix}.{2 * i}.bias",
                "copy"))
  return out


def aggregator_entries(static: bool, anti_alias: bool, scope=(),
                       prefix: str = "") -> List[Entry]:
  """One aggregator's mapping; empty scope/prefix = the bare module."""
  p = prefix + "." if prefix else ""
  e = _mlp(scope + ("ray_dir_fc",), p + "ray_dir_fc", 2)
  for name in ("base_fc", "vis_fc", "vis_fc2", "geometry_fc"):
    e += _mlp(scope + ("vis_pooling", name), p + name, 2)
  for name in ("w_qs", "w_ks", "w_vs", "fc"):
    e.append((scope + ("ray_attention", name, "kernel"),
              f"{p}ray_attention.{name}.weight", "linear"))
  e += [(scope + ("ray_attention", "layer_norm", "scale"),
         p + "ray_attention.layer_norm.weight", "copy"),
        (scope + ("ray_attention", "layer_norm", "bias"),
         p + "ray_attention.layer_norm.bias", "copy")]
  e += _mlp(scope + ("out_geometry_fc",), p + "out_geometry_fc", 2)
  e += _mlp(scope + ("rgb_fc",), p + "rgb_fc", 3)
  if static:
    e += [(scope + ("ref_feature_fc", "kernel"), p + "ref_feature_fc.0.weight",
           "linear"),
          (scope + ("ref_feature_fc", "bias"), p + "ref_feature_fc.0.bias",
           "copy")]
    if anti_alias:
      e.append((scope + ("s",), p + "s", "copy"))
  else:
    e += _mlp(scope + ("ref_pts_fc",), p + "ref_pts_fc", 2)
  return e


def _feature_net(scope, prefix) -> List[Entry]:
  p = prefix + "."
  e = [(scope + ("conv1", "kernel"), p + "conv1.weight", "conv"),
       (scope + ("bn1", "scale"), p + "bn1.weight", "copy"),
       (scope + ("bn1", "bias"), p + "bn1.bias", "copy"),
       (scope + ("out_conv", "kernel"), p + "out_conv.weight", "conv"),
       (scope + ("out_conv", "bias"), p + "out_conv.bias", "copy")]
  for b in range(3):
    blk, tb = scope + (f"layer1_{b}",), f"{p}layer1.{b}."
    for conv, norm in (("conv1", "bn1"), ("conv2", "bn2")):
      e += [(blk + (conv, "kernel"), tb + f"{conv}.weight", "conv"),
            (blk + (norm, "scale"), tb + f"{norm}.weight", "copy"),
            (blk + (norm, "bias"), tb + f"{norm}.bias", "copy")]
    if b == 0:   # the strided block carries the 1×1 downsample
      e += [(blk + ("downsample_conv", "kernel"), tb + "downsample.0.weight",
             "conv"),
            (blk + ("downsample_norm", "scale"), tb + "downsample.1.weight",
             "copy"),
            (blk + ("downsample_norm", "bias"), tb + "downsample.1.bias",
             "copy")]
  return e


def _motion_mlp(scope, prefix, depth: int = 8) -> List[Entry]:
  p = prefix + "."
  e = []
  for i in range(depth):
    e += [(scope + (f"pts_linears_{i}", "kernel"), f"{p}pts_linears.{i}.weight",
           "linear"),
          (scope + (f"pts_linears_{i}", "bias"), f"{p}pts_linears.{i}.bias",
           "copy")]
  return e + [(scope + ("coeff_kernel",), p + "coeff_linear.weight", "linear"),
              (scope + ("coeff_bias",), p + "coeff_linear.bias", "copy")]


def ff_entries(cfg: RenderSettings) -> List[Entry]:
  """The whole FFModel mapping."""
  e: List[Entry] = []
  for stage in ("coarse", "fine"):
    e += aggregator_entries(True, cfg.anti_alias_pooling,
                            (f"net_{stage}_st",), f"net_{stage}_st")
    e += aggregator_entries(False, False, (f"net_{stage}_dy",),
                            f"net_{stage}_dy")
  for name in ("feature_net", "feature_net_fine"):
    e += _feature_net((name,), name)
  for name in ("motion_mlp", "motion_mlp_fine"):
    e += _motion_mlp((name,), name)
  return e + [(("traj_basis",), "traj_basis", "copy"),
              (("traj_basis_fine",), "traj_basis_fine", "copy")]


def mono_entries(cfg: RenderSettings) -> List[Entry]:
  """The whole MonoModel mapping (dynibar_tpu/models/dynibar.py:103-123)."""
  e = aggregator_entries(True, cfg.anti_alias_pooling, ("net_coarse_st",),
                         "net_coarse_st")
  e += aggregator_entries(False, False, ("net_coarse_dy",), "net_coarse_dy")
  for name in ("feature_net", "feature_net_st"):
    e += _feature_net((name,), name)
  return e + _motion_mlp(("motion_mlp",), "motion_mlp") + [
      (("traj_basis",), "traj_basis", "copy")]


def model_entries(model) -> List[Entry]:
  """The mapping of an FFModel or a MonoModel, by its type."""
  if isinstance(model, MonoModel):
    return mono_entries(model.cfg)
  if isinstance(model, FFModel):
    return ff_entries(model.cfg)
  raise TypeError(f"no JAX mapping for {type(model).__name__}")


def _to_torch(a: np.ndarray, kind: str) -> np.ndarray:
  if kind == "linear":
    return a.T
  if kind == "conv":
    return np.transpose(a, (3, 2, 0, 1))
  return a


def _to_jax(a: np.ndarray, kind: str) -> np.ndarray:
  if kind == "linear":
    return a.T
  if kind == "conv":
    return np.transpose(a, (2, 3, 1, 0))
  return a


def _leaves(tree: Dict[str, Any], prefix=()) -> Dict[Tuple[str, ...], Any]:
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out.update(_leaves(v, prefix + (k,)))
    else:
      out[prefix + (k,)] = v
  return out


def jax_params_to_state_dict(params: Dict[str, Any], entries: List[Entry]
                             ) -> Dict[str, torch.Tensor]:
  """JAX params (leaves as numpy) -> state_dict (f32) along `entries`
  (ff_entries, mono_entries or aggregator_entries).

  Raises if a pytree leaf has no place in the port."""
  leaves = _leaves(params)
  sd = {}
  for path, key, kind in entries:
    a = np.asarray(leaves.pop(path), dtype=np.float32)
    sd[key] = torch.from_numpy(np.array(_to_torch(a, kind), order="C"))
  if leaves:
    raise KeyError(f"unmapped JAX params: {sorted(leaves)[:5]}")
  return sd


def state_dict_to_jax_params(sd: Dict[str, torch.Tensor],
                             entries: List[Entry]) -> Dict[str, Any]:
  """state_dict -> JAX params pytree of numpy leaves along `entries`."""
  out: Dict[str, Any] = {}
  for path, key, kind in entries:
    a = sd[key].detach().cpu().numpy()
    node = out
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = np.array(_to_jax(a, kind), order="C")
  return out


def load_jax_params(model, params: Dict[str, Any]) -> None:
  """Load a JAX FFModel or MonoModel params pytree into the port's model
  of the same kind strictly (no missing or unexpected keys)."""
  model.load_state_dict(
      jax_params_to_state_dict(params, model_entries(model)), strict=True)
