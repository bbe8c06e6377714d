"""The benchmark's yardstick of work: flops, bytes and the card's peaks.

Everything here is counted from the cell's shapes, never from the
program, so it stays the same whatever implements the work.

* ``aggregator_flop_parts`` and ``static_inmlp_flops``: frozen copies of
  dynibar_tpu_torch/ops/agg.py (commit a749e58): the aggregators' matmul
  flops, 2 per multiply-add, elementwise work left out.
* ``aggregator_bytes``: each input read once, each output written once,
  the weights read once in bf16 (chip_smoke.py's rule for K2/K3); the
  backward reads the inputs, the output's gradient and the weights and
  writes the inputs' gradients and the weights' f32 gradients.
* The backward counts as twice the forward's matmul flops; recomputation
  is not counted.
* ``featnet_flops`` and ``motion_mlp_flops``: the feature nets'
  convolutions over the source images and the motion MLP's linear layers,
  from the reference modules' layer shapes (2 flops per multiply-add).
* Peaks: one H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s bf16,
  3.35 TB/s HBM3, at the 700 W power limit.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, Tuple

import torch
import torch.nn as nn

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _mlp_macs(dims) -> int:
  return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def aggregator_flop_parts(static: bool, r: int, s: int, v: int, c: int
                          ) -> Tuple[int, int]:
  """Matmul flops of the forward (2 per multiply-add) for these shapes,
  split as (trunk side: per-(point, view) MLPs; ray side: geometry_fc,
  attention, heads).  Elementwise work is left out."""
  p = r * s
  trunk = (_mlp_macs((3 * (2 * c if static else c), 256, 128))
           + _mlp_macs((128, 128, 129)) + _mlp_macs((128, 128, 1)))
  if static:
    trunk += _mlp_macs((103, 256, c))
  per_point = (_mlp_macs((257, 256, 128)) + 4 * 128 * 128
               + _mlp_macs((128, 128, 1)))
  if static:
    per_point += v * _mlp_macs((261, 128, 64, 1))
  else:
    per_point += _mlp_macs((161, 256, 128)) + _mlp_macs((155, 128, 64, 3))
  attention = 2 * s * s * 128
  return 2 * p * v * trunk, 2 * (p * per_point + r * attention)


def static_inmlp_flops(r: int, s: int, v: int, c: int) -> int:
  """Matmul flops of the static input MLP ray_dir_fc's forward."""
  return 2 * r * s * v * _mlp_macs((103, 256, c))


@functools.lru_cache(maxsize=None)
def aggregator_params(static: bool, c: int) -> int:
  """Parameters of one aggregator module with c = 3 + feature channels."""
  from portbench.reference.aggregators import (DynamicAggregator,
                                               StaticAggregator)
  with torch.device("meta"):
    net = (StaticAggregator(c - 3, 64, True, True) if static
           else DynamicAggregator(c - 3, 64, shift=0.0))
  return sum(p.numel() for p in net.parameters())


def aggregator_bytes(static: bool, r: int, s: int, v: int, c: int,
                     backward: bool = False) -> int:
  """Bytes of one aggregator call: bf16 sampled features and masks, f32
  geometry, f32 outputs, bf16 weights (f32 weight gradients)."""
  p = r * s
  ins = p * 3 * 4 + p * v * c * 2 + p * v * 2        # pts, rgb_feat, mask
  if static:
    ins += p * v * 4 * 4 + r * 6 * 4 + p * v * 6 * 4  # ray_diff, ref/src pl
  else:
    ins += r * 3 * 4 + p * 4                         # ray_dir, time
  out = p * 4 * 4
  w = aggregator_params(static, c)
  if not backward:
    return ins + out + 2 * w
  return 2 * ins + out + 2 * w + 4 * w


def aggregator_flops(static: bool, r: int, s: int, v: int, c: int,
                     backward: bool = False) -> int:
  f = sum(aggregator_flop_parts(static, r, s, v, c))
  return 2 * f if backward else f


def least_seconds(flops: float, nbytes: float) -> float:
  """The least time the card could take: the larger of the two bounds."""
  return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


@functools.lru_cache(maxsize=None)
def featnet_flops(views: int, h: int, w: int, c_coarse: int = 32,
                  c_fine: int = 32) -> int:
  """Convolution flops of one FeatureNet forward over ``views`` images of
  h × w, from the reference module's layers on the meta device."""
  from portbench.reference.feature_net import FeatureNet
  with torch.device("meta"):
    net = FeatureNet(c_coarse, c_fine)
    total = [0]

    def hook(m, _inp, out):
      k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
      total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, nn.Conv2d)]
    net(torch.empty(views, h, w, 3))
    for hd in handles:
      hd.remove()
  return total[0]


@functools.lru_cache(maxsize=None)
def motion_mlp_flops(points: int, num_basis: int = 6) -> int:
  """Linear-layer flops of the motion MLP over ``points`` (x, y, z, t)."""
  from portbench.reference.motion_mlp import MotionMLP
  with torch.device("meta"):
    net = MotionMLP(num_basis)
  macs = sum(m.in_features * m.out_features for m in net.modules()
             if isinstance(m, nn.Linear))
  return 2 * points * macs


def unit_work(work: Dict) -> Dict[str, float]:
  """Flops and bytes of one unit (a train step, a frame) from the
  driver's shape list:

  ``agg``: [(static, rays, samples, views, c, backward)],
  ``featnet``: [(views, h, w, backward)] (times ``featnet_share`` where a
  frame's feature maps serve several units), ``motion``: [(points,
  backward)].  A backward adds twice its forward's flops."""
  agg_f = agg_b = 0
  agg_fwd_f = agg_fwd_b = 0
  for static, r, s, v, c, bwd in work.get("agg", ()):
    f, b = aggregator_flops(static, r, s, v, c), aggregator_bytes(
        static, r, s, v, c)
    agg_fwd_f += f
    agg_fwd_b += b
    agg_f += f
    agg_b += b
    if bwd:
      agg_f += aggregator_flops(static, r, s, v, c, backward=True)
      agg_b += aggregator_bytes(static, r, s, v, c, backward=True)
  conv = sum(featnet_flops(v, h, w) * (3 if bwd else 1)
             for v, h, w, bwd in work.get("featnet", ()))
  mlp = sum(motion_mlp_flops(n) * (3 if bwd else 1)
            for n, bwd in work.get("motion", ()))
  return {"agg_flops": float(agg_f), "agg_bytes": float(agg_b),
          "agg_least_s": least_seconds(agg_f, agg_b),
          "agg_fwd_flops": float(agg_fwd_f),
          "model_flops": float(agg_f + conv + mlp),
          "featnet_flops": float(conv), "motion_flops": float(mlp)}


def mono_agg_calls(r: int, s: int, v_dy: int, v_st: int, v_anchor: int,
                   c: int, train: bool) -> Iterable[tuple]:
  """The aggregator calls of one mono render of r rays (train: with the
  anchor branch and the backward)."""
  calls = [(True, r, s, v_st, c, train), (False, r, s, v_dy, c, train)]
  if train:
    calls.append((False, r, s, v_anchor, c, True))
  return calls
