"""K2/K3: the fused static and dynamic aggregators.

``fused_static_aggregator`` replaces ``dynibar_tpu/ops/pallas_agg.py:225
_static_kernel`` (launched by ``fused_static_aggregator`` :783) and
``fused_dynamic_aggregator`` replaces ``:325 _dynamic_kernel`` (launched by
``fused_dynamic_aggregator`` :1148).  Both take the inputs of the
matching module's ``forward`` ([R,S,V,·] layout) and return raw [R,S,4].

For CPU tensors they run the module's forward (the plain f32 twin).  For
CUDA tensors they launch the CUDA kernels (csrc/static_agg.cu,
csrc/dynamic_agg.cu): bf16 operands, f32 accumulation, and every
reduction, softmax and normalization in f32.  The per-ray work that the
JAX wrapper also runs outside its kernel stays torch ops here:
``ref_feature_fc`` (pallas_agg.py:814-820), the time-PE ``ray_dir_fc``
(:1187-1194) and ``dir_pe`` (:1196-1199).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dynibar_tpu_torch.core.posenc import periodic_embed
from dynibar_tpu_torch.models.nn_layers import linear_layers
from dynibar_tpu_torch.ops import build

# layer slots of the packed weights; csrc/agg_common.cuh names the same ids
N_LAYERS = 23
_MAX_VIEWS, _MAX_SAMPLES, _MAX_CH = 12, 128, 40

_P = ctypes.c_void_p
_STATIC_ARGS = ([_P] * 9 + [ctypes.c_int] * 2 + [_P] * 7 + [ctypes.c_int] * 4
                + [_P])
_DYNAMIC_ARGS = ([_P] * 9 + [ctypes.c_float] + [_P] * 6 + [ctypes.c_int] * 4
                 + [_P])


def _ceil16(n: int) -> int:
  return -(-n // 16) * 16


def _layer_list(net: nn.Module, static: bool):
  """(weight [out,in], bias [out] or None) per slot; None = empty slot;
  slot 14 carries the LayerNorm (scale, bias), slot 22 the static
  anti-alias scalar s (read on the device: no host sync per call)."""
  slots: List[Optional[Tuple[torch.Tensor, ...]]] = [None] * N_LAYERS

  def put(first, seq):
    for i, lin in enumerate(linear_layers(seq)):
      slots[first + i] = (lin.weight, lin.bias)

  if static:
    put(0, net.ray_dir_fc)
  put(2, net.base_fc)
  put(4, net.vis_fc)
  put(6, net.vis_fc2)
  put(8, net.geometry_fc)
  att = net.ray_attention
  for i, lin in enumerate((att.w_qs, att.w_ks, att.w_vs, att.fc)):
    slots[10 + i] = (lin.weight, None)
  slots[14] = ("bias_only", att.layer_norm.weight, att.layer_norm.bias)
  put(15, net.out_geometry_fc)
  put(17, net.rgb_fc)
  if not static:
    put(20, net.ref_pts_fc)
  elif net.anti_alias_pooling:
    slots[22] = ("bias_only", net.s.reshape(1))
  return slots


def pack_weights(net: nn.Module, static: bool):
  """Packed bf16 weights, f32 biases and the [N_LAYERS, 4] slot table
  (weight offset, bias offset, padded in, padded out).

  Each weight is zero-padded to [ceil16(out), ceil16(in)] so the kernels'
  16×16×16 tensor-core tiles need no edge cases; offsets stay multiples of
  256 elements, which keeps every tile 32-byte aligned.  Cached on the
  module until a parameter changes."""
  params = list(net.parameters())
  key = (params[0].device, tuple(p._version for p in params),
         tuple(p.data_ptr() for p in params))
  cached = getattr(net, "_kernel_pack", None)
  if cached is not None and cached[0] == key:
    return cached[1]
  dev = params[0].device
  w_parts, b_parts = [], []
  meta = np.zeros((N_LAYERS, 4), np.int32)
  w_off = b_off = 0
  for i, slot in enumerate(_layer_list(net, static)):
    if slot is None:
      continue
    if isinstance(slot[0], str):           # LayerNorm or the scalar s
      extra = [t.detach().float() for t in slot[1:]]
      b_parts += extra
      meta[i] = (-1, b_off, 0, 0)
      b_off += sum(t.numel() for t in extra)
      continue
    w, b = slot
    n, k = w.shape
    kp, np_ = _ceil16(k), _ceil16(n)
    wp = torch.zeros((np_, kp), dtype=torch.float32, device=dev)
    wp[:n, :k] = w.detach()
    bp = torch.zeros((np_,), dtype=torch.float32, device=dev)
    if b is not None:
      bp[:n] = b.detach()
    w_parts.append(wp.reshape(-1))
    b_parts.append(bp)
    meta[i] = (w_off, b_off, kp, np_)
    w_off += np_ * kp
    b_off += np_
  packed = (torch.cat(w_parts).to(torch.bfloat16).contiguous(),
            torch.cat(b_parts).contiguous(), np.ascontiguousarray(meta))
  net._kernel_pack = (key, packed)
  return packed


def _check(t: torch.Tensor, name: str, shape, dtype, device):
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
  if t.dtype != dtype or t.device != device or not t.is_contiguous():
    raise ValueError(f"{name}: expected contiguous {dtype} on {device}")


def _check_dims(s: int, v: int, c: int):
  if s > _MAX_SAMPLES or v > _MAX_VIEWS or c > _MAX_CH:
    raise ValueError(f"kernel limits: S<={_MAX_SAMPLES}, V<={_MAX_VIEWS}, "
                     f"3+C<={_MAX_CH}; got S={s}, V={v}, 3+C={c}")


def _meta_ptr(meta: np.ndarray) -> int:
  return meta.ctypes.data_as(ctypes.c_void_p).value


def fused_static_aggregator(net: nn.Module, pts, ref_pl, src_pl, rgb_feat,
                            ray_diff, mask) -> torch.Tensor:
  """K2 wrapper; arguments as StaticAggregator.forward."""
  if not rgb_feat.is_cuda:
    return net(pts, ref_pl, src_pl, rgb_feat, ray_diff, mask)
  r, s, v, c = rgb_feat.shape
  _check_dims(s, v, c)
  dev, p = rgb_feat.device, r * s
  w, b, meta = pack_weights(net, static=True)
  ref_pe = periodic_embed(ref_pl.float(), 5, 5, linspace=False)
  reffeat = net.ref_feature_fc(ref_pe).contiguous()             # [R,C]
  rgbf = rgb_feat.to(torch.bfloat16).contiguous()
  args = dict(pts=(pts.float().contiguous(), (r, s, 3)),
              reffeat=(reffeat, (r, c)),
              rgb_feat=(rgbf, (r, s, v, c)),
              ray_diff=(ray_diff.float().contiguous(), (r, s, v, 4)),
              mask=(mask.float().contiguous(), (r, s, v, 1)),
              src_pl=(src_pl.float().contiguous(), (r, s, v, 6)))
  for name, (t, shape) in args.items():
    _check(t, name, shape, torch.bfloat16 if name == "rgb_feat"
           else torch.float32, dev)
  ws_rf = torch.empty((v, p, 2 * c), dtype=torch.bfloat16, device=dev)
  ws_x = torch.empty((v, p, 128), dtype=torch.bfloat16, device=dev)
  ws_vm = torch.empty((2, v, p), dtype=torch.float32, device=dev)
  ws_gf = torch.empty((p, 128), dtype=torch.float32, device=dev)
  ws_nv = torch.empty((p,), dtype=torch.float32, device=dev)
  out = torch.empty((r, s, 4), dtype=torch.float32, device=dev)
  fn = build.load("static_agg").dyn_static_agg
  fn.argtypes, fn.restype = _STATIC_ARGS, ctypes.c_int
  stream = torch.cuda.current_stream(dev).cuda_stream
  ins = [t for t, _ in args.values()]
  build.check(fn(w.data_ptr(), b.data_ptr(), _meta_ptr(meta),
                 *(t.data_ptr() for t in ins),
                 int(net.anti_alias_pooling), int(net.mask_rgb),
                 ws_rf.data_ptr(), ws_x.data_ptr(), ws_vm[0].data_ptr(),
                 ws_vm[1].data_ptr(), ws_gf.data_ptr(), ws_nv.data_ptr(),
                 out.data_ptr(), r, s, v, c, stream), "static aggregator")
  fused_static_aggregator.launches += 1
  return out


def fused_dynamic_aggregator(net: nn.Module, pts, rgb_feat, glb_ray_dir,
                             mask, time) -> torch.Tensor:
  """K3 wrapper; arguments as DynamicAggregator.forward."""
  if not rgb_feat.is_cuda:
    return net(pts, rgb_feat, glb_ray_dir, mask, time)
  r, s, v, c = rgb_feat.shape
  _check_dims(s, v, c)
  dev, p = rgb_feat.device, r * s
  w, b, meta = pack_weights(net, static=False)
  dirfeat = net.direction_feature(time.float()).contiguous()   # [R,S,C]
  dirpe = periodic_embed(glb_ray_dir.float(), 4, 4,
                         linspace=False).contiguous()         # [R,27]
  posenc = net.pos_enc[:s].contiguous()                         # [S,128]
  args = dict(pts=(pts.float().contiguous(), (r, s, 3)),
              dirfeat=(dirfeat, (r, s, c)), dirpe=(dirpe, (r, 27)),
              posenc=(posenc, (s, 128)),
              rgb_feat=(rgb_feat.to(torch.bfloat16).contiguous(),
                        (r, s, v, c)),
              mask=(mask.float().contiguous(), (r, s, v, 1)))
  for name, (t, shape) in args.items():
    _check(t, name, shape, torch.bfloat16 if name == "rgb_feat"
           else torch.float32, dev)
  ws_x = torch.empty((v, p, 128), dtype=torch.bfloat16, device=dev)
  ws_vm = torch.empty((2, v, p), dtype=torch.float32, device=dev)
  ws_gf = torch.empty((p, 128), dtype=torch.float32, device=dev)
  ws_nv = torch.empty((p,), dtype=torch.float32, device=dev)
  out = torch.empty((r, s, 4), dtype=torch.float32, device=dev)
  fn = build.load("dynamic_agg").dyn_dynamic_agg
  fn.argtypes, fn.restype = _DYNAMIC_ARGS, ctypes.c_int
  stream = torch.cuda.current_stream(dev).cuda_stream
  ins = [t for t, _ in args.values()]
  build.check(fn(w.data_ptr(), b.data_ptr(), _meta_ptr(meta),
                 *(t.data_ptr() for t in ins), float(net.shift),
                 ws_x.data_ptr(), ws_vm[0].data_ptr(), ws_vm[1].data_ptr(),
                 ws_gf.data_ptr(), ws_nv.data_ptr(), out.data_ptr(),
                 r, s, v, c, stream), "dynamic aggregator")
  fused_dynamic_aggregator.launches += 1
  return out


fused_static_aggregator.launches = 0
fused_dynamic_aggregator.launches = 0


def _mlp_macs(dims) -> int:
  return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def aggregator_flops(static: bool, r: int, s: int, v: int, c: int) -> int:
  """Matmul flops the kernel does for these shapes (2 per multiply-add):
  the per-(point, view) MLPs, the per-point MLPs and the per-ray
  attention.  Elementwise work is left out."""
  p = r * s
  trunk = (_mlp_macs((3 * (2 * c if static else c), 256, 128))
           + _mlp_macs((128, 128, 129)) + _mlp_macs((128, 128, 1)))
  per_view = trunk + (_mlp_macs((103, 256, c)) + _mlp_macs((261, 128, 64, 1))
                      if static else 0)
  per_point = (_mlp_macs((257, 256, 128)) + 4 * 128 * 128
               + _mlp_macs((128, 128, 1)))
  if not static:
    per_point += _mlp_macs((161, 256, 128)) + _mlp_macs((155, 128, 64, 3))
  attention = 2 * s * s * 128
  return 2 * (p * (v * per_view + per_point) + r * attention)
