"""K2-K5: the fused static and dynamic aggregators and their backwards.

Forward kernels (take the inputs of the matching module's ``forward``,
[R,S,V,·] layout, and return raw [R,S,4]):

  * K2 ``fused_static_aggregator`` replaces ``dynibar_tpu/ops/pallas_agg.py
    :225 _static_kernel`` and K3 ``fused_dynamic_aggregator`` replaces
    ``:325 _dynamic_kernel`` (csrc/static_agg.cu, csrc/dynamic_agg.cu);
  * K2r / K3r are the same launches with their workspaces kept as the
    residuals of the backward, as ``_static_kernel(emit_residuals=True)``
    (pallas_agg.py:587) and ``_dynamic_kernel(emit_residuals=True)``
    (:1033) keep theirs.

Backward kernels (csrc/static_agg_bwd.cu, csrc/static_agg_bwd3.cu,
csrc/dynamic_agg_bwd.cu), a ray-side and a trunk-side launch as in
``pallas_agg_bwd.py``: K4a/K4b (dynamic, :514/:733) and K5a/K5b (static,
:879/:1109).  K4a and K5a/K5b are written for Hopper (wgmma on weight
slabs staged in shared memory by bulk copies) and read the weights in the
tiled layout of ``tile_weights``; the forwards K2/K3 and the trunk
backwards K4b/K5c/K5d (and K4s's trunk phases) read them fragment-major
(``pack_frag``, the transposes ``pack_frag_t``).  The dynamic
backward's route "pallas" is one launch instead
(csrc/dynamic_agg_bwd1.cu): K4s replaces ``pallas_agg_bwd.py:163
dynamic_bwd_kernel``; its forward K3p (``_dynamic_kernel`` under
``_make_dyn_core_diff``, pallas_agg.py:925) is the K3 launch with no
residuals kept, and the backward recomputes them.  The static backward's
route "pallas_split3" splits the trunk side at the d_rf seam as
``_make_st_core_diff_split(three_kernel=True)`` does
(pallas_agg.py:556-559): K5c (:1328, the trunk) then K5d (:1484, the
per-view input MLP).  The last trunk-side wrapper also
launches the small kernel that sums the per-block weight-gradient slabs.

Dispatch: CPU tensors run the module's forward (the plain f32 twin, under
autograd when grad is enabled).  CUDA tensors launch the kernels: under
``torch.no_grad()`` K2/K3; with grad enabled the autograd Functions
(K2r forward, K5a+K5b or K5a+K5c+K5d backward; K3r forward, K4a+K4b
backward, or K3p forward, K4s backward), so a CUDA call never returns a
tensor without a graph.  The routes come from the caller
(``RenderSettings.fused_st_bwd_impl``, ``fused_bwd_impl``); an unknown
route raises, on the CPU too, and no route runs another's kernels.  The
per-ray pieces the JAX wrappers also run outside their kernels stay torch
ops and get their gradients from autograd through the returned input
cotangents: ``ref_feature_fc``
(pallas_agg.py:814-820), the time-PE ``ray_dir_fc`` (:1187-1194) and
``dir_pe`` (:1196-1199).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dynibar_tpu_torch.config import (DYNAMIC_BWD_ROUTES, STATIC_BWD_ROUTES,
                                     check_route)
from dynibar_tpu_torch.core.posenc import periodic_embed
from dynibar_tpu_torch.models.nn_layers import linear_layers
from dynibar_tpu_torch.ops import build

# layer slots of the packed weights; csrc/agg_common.cuh names the same ids
N_LAYERS = 23
_LN, _AA_S = 14, 22
_MAX_VIEWS, _MAX_SAMPLES, _MAX_CH = 14, 128, 40   # csrc VMAX, SMAX, CMAX
_MAX_CH_STATIC_BWD = 36          # 2·(3+C) <= 72 f32 columns in K5b/K5c
_SCRATCH_LD = 128 + 128 + 272    # csrc kScratchLd, kRayScratchLd
_TRUNK_LDF = 144                 # csrc/trunk_bwd_sm90.cuh kTrunkLdf
_N_SLABS = 16                    # csrc/agg_bwd_common.cuh kSlabs

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STATIC_ARGS = [_P] * 9 + [_I] * 2 + [_P] * 7 + [_I] * 4 + [_P]
_DYNAMIC_ARGS = [_P] * 9 + [_F] + [_P] * 6 + [_I] * 4 + [_P]
_DYN_RAY_ARGS = [_P] * 18 + [_I] * 7 + [_P]
_DYN_TRUNK_ARGS = [_P] * 13 + [_I] * 7 + [_P]
_ST_RAY_ARGS = [_P] * 15 + [_I] * 7 + [_P]
_ST_TRUNK_ARGS = [_P] * 10 + [_I] * 2 + [_P] * 11 + [_I] * 7 + [_P]
_ST_TRUNK3_ARGS = [_P] * 8 + [_I] * 2 + [_P] * 6 + [_I] * 7 + [_P]
_ST_INMLP_ARGS = [_P] * 17 + [_I] * 7 + [_P]
_DYN_SINGLE_ARGS = [_P] * 26 + [_I] * 7 + [_P]
_REDUCE_ARGS = [_P, _I, _I, _P, _P]


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
  slots[_LN] = ("bias_only", att.layer_norm.weight, att.layer_norm.bias)
  put(15, net.out_geometry_fc)
  put(17, net.rgb_fc)
  if not static:
    put(20, net.ref_pts_fc)
  elif net.anti_alias_pooling:
    slots[_AA_S] = ("bias_only", net.s)
  return slots


def kernel_params(net: nn.Module, static: bool) -> List[torch.Tensor]:
  """The parameters the kernels read, in slot order (weight, then bias)."""
  out = []
  for slot in _layer_list(net, static):
    if slot is not None:
      out += [t for t in slot if isinstance(t, torch.Tensor)]
  return out


def pack_weights(net: nn.Module, static: bool):
  """Packed bf16 weights, f32 biases and the [N_LAYERS, 4] slot table
  (weight offset, bias offset, padded in, padded out).

  Each weight is zero-padded to [ceil16(out), ceil16(in)] so the kernels'
  16×16×16 tensor-core tiles need no edge cases; offsets stay multiples of
  256 elements, which keeps every tile 32-byte aligned.  Cached on the
  module until a parameter changes (an optimizer step bumps every
  ``_version``); ``pack_tiled``, ``pack_frag`` and ``pack_frag_t`` are
  the same weights in the other kernels' layouts."""
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
      extra = [t.detach().float().reshape(-1) for t in slot[1:]]
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


def _frag_order(np_: int, kp: int) -> np.ndarray:
  """Row-major index [N, K] of every element of ``pack_frag``'s layer."""
  nt, kk, lane, j, e = np.meshgrid(np.arange(np_ // 16), np.arange(kp // 16),
                                   np.arange(32), np.arange(4), np.arange(2),
                                   indexing="ij")
  row = nt * 16 + lane // 4 + 8 * (j // 2)
  col = kk * 16 + 8 * (j % 2) + 2 * (lane % 4) + e
  return (row * kp + col).reshape(-1)


@functools.lru_cache(maxsize=16)
def _order(meta_bytes: bytes, total: int, layout: str,
           device: torch.device) -> torch.Tensor:
  """Source index of every element of a relaid pack (``layout``: "tiled",
  see ``tile_weights``; "frag", ``pack_frag``; "frag_t", ``pack_frag_t``),
  built once per slot table and device."""
  meta = np.frombuffer(meta_bytes, np.int32).reshape(-1, 4)
  idx = np.arange(total)
  for w_off, _, kp, np_ in (tuple(int(x) for x in row) for row in meta):
    if w_off < 0 or np_ == 0:       # LayerNorm / scalar / empty slots
      continue
    layer = idx[w_off:w_off + np_ * kp].reshape(np_, kp)
    if layout == "frag":
      idx[w_off:w_off + np_ * kp] = layer.reshape(-1)[_frag_order(np_, kp)]
      continue
    if layout == "frag_t":
      idx[w_off:w_off + np_ * kp] = layer.T.reshape(-1)[_frag_order(kp, np_)]
      continue
    parts = []
    for n0 in range(0, np_, 64):
      bn = min(64, np_ - n0)
      for k0 in range(0, kp, 64):
        bk = min(64, kp - k0)
        blk = layer[n0:n0 + bn, k0:k0 + bk].reshape(bn // 8, 8, bk // 8, 8)
        parts.append(blk.transpose(0, 2, 1, 3).reshape(-1))
    idx[w_off:w_off + np_ * kp] = np.concatenate(parts)
  return torch.from_numpy(idx).to(device)


def tile_weights(w: torch.Tensor, meta: np.ndarray) -> torch.Tensor:
  """The packed weights laid out for the Hopper kernels K4a, K5a/K5b
  (csrc/sm90_common.cuh): each padded layer [N, K] at its offset, cut into
  blocks of at most 64 x 64 stored one after the other (row blocks, then
  column blocks), each block's 8x8 core matrices row-major, each 8 rows of
  8 consecutive k.  A block is one bulk copy and serves the forward and
  the transposed products.  One gather."""
  return w[_order(meta.tobytes(), w.numel(), "tiled", w.device)]


def _relaid(net: nn.Module, static: bool, layout: str):
  w, _, meta = pack_weights(net, static)
  attr = f"_kernel_{layout}"
  cached = getattr(net, attr, None)
  if cached is None or cached[0] is not w:
    cached = (w, w[_order(meta.tobytes(), w.numel(), layout, w.device)])
    setattr(net, attr, cached)
  return cached[1]


def pack_tiled(net: nn.Module, static: bool) -> torch.Tensor:
  """``tile_weights`` of ``pack_weights``, cached with the pack."""
  return _relaid(net, static, "tiled")


def pack_frag(net: nn.Module, static: bool) -> torch.Tensor:
  """``pack_weights`` laid out as the forwards' products read it
  (csrc/agg_common.cuh dense_deep): each padded layer [N, K] at its
  offset as [N/16][K/16][32 lanes][8], a lane's eight values the four
  bf16 pairs of its mma.sync B fragments for one 16x16 tile (rows g and
  g + 8, columns 2t and 8 + 2t, with g = lane / 4, t = lane % 4), so one
  16-byte load per lane and k-step fetches them.  Cached with the pack."""
  return _relaid(net, static, "frag")


def pack_frag_t(net: nn.Module, static: bool) -> torch.Tensor:
  """``pack_frag`` of each layer's transpose: the padded W^T [K, N] at W's
  offset as [K/16][N/16][32 lanes][8], the layout of the trunk backwards'
  transposed products dX = dY W (K4b, K5c, K5d, K4s's trunk phase).  Built
  only when one of them runs, cached with the pack."""
  return _relaid(net, static, "frag_t")


def unpack_grads(net: nn.Module, static: bool, meta: np.ndarray,
                 grads: torch.Tensor, w_total: int,
                 d_s: Optional[torch.Tensor]) -> List[torch.Tensor]:
  """Packed f32 gradients [weights | biases] -> one tensor per
  ``kernel_params`` entry (padding cut away)."""
  gw, gb = grads[:w_total], grads[w_total:]
  out = []
  for i, slot in enumerate(_layer_list(net, static)):
    if slot is None:
      continue
    w_off, b_off, kp, np_ = (int(x) for x in meta[i])
    if i == _AA_S:
      out.append(d_s.reshape(slot[1].shape))
    elif i == _LN:
      out += [gb[b_off:b_off + 128], gb[b_off + 128:b_off + 256]]
    else:
      w, b = slot
      n, k = w.shape
      g = gw[w_off:w_off + np_ * kp].view(np_, kp)
      out.append(g[:n, :k].contiguous())
      if b is not None:
        out.append(gb[b_off:b_off + n])
  return out


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


def _fn(lib: str, name: str, argtypes):
  fn = getattr(build.load(lib), name)
  fn.argtypes, fn.restype = argtypes, ctypes.c_int
  return fn


# each library's kernels, in the order of its dyn_occupancy output
_OCCUPANCY = {"static_agg": ("K2 trunk", "K2 ray"),
              "dynamic_agg": ("K3 trunk", "K3 ray"),
              "static_agg_bwd": ("K5a", "K5b"),
              "static_agg_bwd3": ("K5c", "K5d"),
              "dynamic_agg_bwd": ("K4a", "K4b"),
              "dynamic_agg_bwd1": ("K4s",)}


def occupancy(v: int) -> Dict[str, Tuple[int, int]]:
  """Each aggregator kernel's dynamic shared memory at `v` views and the
  blocks of it one SM of the current card holds (CUDA's occupancy
  calculator): {kernel: (bytes, blocks per SM)}."""
  out = {}
  for lib, names in _OCCUPANCY.items():
    buf = (ctypes.c_int * 4)()
    fn = _fn(lib, "dyn_occupancy", [_I, ctypes.POINTER(ctypes.c_int)])
    build.check(fn(v, buf), f"{lib} occupancy")
    for i, name in enumerate(names):
      out[name] = (buf[2 * i], buf[2 * i + 1])
  return out


def _stream(dev) -> int:
  return torch.cuda.current_stream(dev).cuda_stream


def _slabs(dev, packed) -> Tuple[torch.Tensor, int, int]:
  """Zeroed weight-gradient slabs (csrc/agg_bwd_common.cuh kSlabs) and the
  persistent grid: one block per SM."""
  nblk = torch.cuda.get_device_properties(dev).multi_processor_count
  w_total, b_total = packed[0].numel(), packed[1].numel()
  # 16-byte aligned slabs: the kernels add weight tiles as float2
  slab_len = -(-(w_total + b_total) // 4) * 4
  return (torch.zeros((_N_SLABS, slab_len), dtype=torch.float32, device=dev),
          nblk, w_total)


# --------------------------------------------------------------------------
# forward launches (K2/K2r, K3/K3r)
# --------------------------------------------------------------------------

def _static_launch(net, pts, reffeat, src_pl, rgb_feat, ray_diff, mask):
  """The K2 launch; returns raw [R,S,4] and the workspaces (residuals)."""
  r, s, v, c = rgb_feat.shape
  _check_dims(s, v, c)
  dev, p = rgb_feat.device, r * s
  _, b, meta = pack_weights(net, static=True)
  w = pack_frag(net, static=True)
  args = dict(pts=(pts.detach().float().contiguous(), (r, s, 3)),
              reffeat=(reffeat.detach().float().contiguous(), (r, c)),
              rgb_feat=(rgb_feat.detach().to(torch.bfloat16).contiguous(),
                        (r, s, v, c)),
              ray_diff=(ray_diff.detach().float().contiguous(), (r, s, v, 4)),
              mask=(mask.detach().float().contiguous(), (r, s, v, 1)),
              src_pl=(src_pl.detach().float().contiguous(), (r, s, v, 6)))
  for name, (t, shape) in args.items():
    _check(t, name, shape, torch.bfloat16 if name == "rgb_feat"
           else torch.float32, dev)
  ws = dict(rf=torch.empty((v, p, 2 * c), dtype=torch.bfloat16, device=dev),
            x=torch.empty((v, p, 128), dtype=torch.bfloat16, device=dev),
            vm=torch.empty((2, v, p), dtype=torch.float32, device=dev),
            gf=torch.empty((p, 128), dtype=torch.float32, device=dev),
            nv=torch.empty((p,), dtype=torch.float32, device=dev))
  out = torch.empty((r, s, 4), dtype=torch.float32, device=dev)
  fn = _fn("static_agg", "dyn_static_agg", _STATIC_ARGS)
  ins = [t for t, _ in args.values()]
  build.check(fn(w.data_ptr(), b.data_ptr(), _meta_ptr(meta),
                 *(t.data_ptr() for t in ins),
                 int(net.anti_alias_pooling), int(net.mask_rgb),
                 ws["rf"].data_ptr(), ws["x"].data_ptr(),
                 ws["vm"][0].data_ptr(), ws["vm"][1].data_ptr(),
                 ws["gf"].data_ptr(), ws["nv"].data_ptr(), out.data_ptr(),
                 r, s, v, c, _stream(dev)), "static aggregator")
  ws.update({k: t for k, (t, _) in args.items()})
  return out, ws


def _dynamic_launch(net, pts, dirfeat, dirpe, rgb_feat, mask):
  """The K3 launch; returns raw [R,S,4] and the workspaces (residuals)."""
  r, s, v, c = rgb_feat.shape
  _check_dims(s, v, c)
  dev, p = rgb_feat.device, r * s
  _, b, meta = pack_weights(net, static=False)
  w = pack_frag(net, static=False)
  posenc = net.pos_enc[:s].contiguous()                         # [S,128]
  args = dict(pts=(pts.detach().float().contiguous(), (r, s, 3)),
              dirfeat=(dirfeat.detach().float().contiguous(), (r, s, c)),
              dirpe=(dirpe.detach().float().contiguous(), (r, 27)),
              posenc=(posenc, (s, 128)),
              rgb_feat=(rgb_feat.detach().to(torch.bfloat16).contiguous(),
                        (r, s, v, c)),
              mask=(mask.detach().float().contiguous(), (r, s, v, 1)))
  for name, (t, shape) in args.items():
    _check(t, name, shape, torch.bfloat16 if name == "rgb_feat"
           else torch.float32, dev)
  ws = dict(x=torch.empty((v, p, 128), dtype=torch.bfloat16, device=dev),
            vm=torch.empty((2, v, p), dtype=torch.float32, device=dev),
            gf=torch.empty((p, 128), dtype=torch.float32, device=dev),
            nv=torch.empty((p,), dtype=torch.float32, device=dev))
  out = torch.empty((r, s, 4), dtype=torch.float32, device=dev)
  fn = _fn("dynamic_agg", "dyn_dynamic_agg", _DYNAMIC_ARGS)
  ins = [t for t, _ in args.values()]
  build.check(fn(w.data_ptr(), b.data_ptr(), _meta_ptr(meta),
                 *(t.data_ptr() for t in ins), float(net.shift),
                 ws["x"].data_ptr(), ws["vm"][0].data_ptr(),
                 ws["vm"][1].data_ptr(), ws["gf"].data_ptr(),
                 ws["nv"].data_ptr(), out.data_ptr(), r, s, v, c,
                 _stream(dev)), "dynamic aggregator")
  ws.update({k: t for k, (t, _) in args.items()})
  return out, ws


def _reffeat(net, ref_pl):
  return net.ref_feature_fc(periodic_embed(ref_pl.float(), 5, 5,
                                           linspace=False))      # [R,C]


def _dir_inputs(net, glb_ray_dir, time):
  dirfeat = net.direction_feature(time.float())                  # [R,S,C]
  dirpe = periodic_embed(glb_ray_dir.float(), 4, 4, linspace=False)
  return dirfeat, dirpe                                          # [R,27]


def fused_static_aggregator(net: nn.Module, pts, ref_pl, src_pl, rgb_feat,
                            ray_diff, mask, bwd: str = "pallas_split"
                            ) -> torch.Tensor:
  """Static aggregator; arguments as StaticAggregator.forward.  bwd: the
  backward route on the card, "pallas_split" (K5a + K5b) or
  "pallas_split3" (K5a + K5c + K5d); both take the twin on the CPU."""
  check_route("fused_st_bwd_impl", bwd, STATIC_BWD_ROUTES)
  if not rgb_feat.is_cuda:
    return net(pts, ref_pl, src_pl, rgb_feat, ray_diff, mask)
  return _static_cuda(net, pts, ref_pl, src_pl, rgb_feat, ray_diff, mask,
                      bwd)


def _static_cuda(net, pts, ref_pl, src_pl, rgb_feat, ray_diff, mask,
                 bwd: str = "pallas_split"):
  reffeat = _reffeat(net, ref_pl)
  if torch.is_grad_enabled():
    return _StaticAggFn.apply(net, bwd, pts, reffeat, src_pl, rgb_feat,
                              ray_diff, mask, *kernel_params(net, True))
  out, _ = _static_launch(net, pts, reffeat, src_pl, rgb_feat, ray_diff, mask)
  fused_static_aggregator.launches += 1
  return out


def fused_dynamic_aggregator(net: nn.Module, pts, rgb_feat, glb_ray_dir,
                             mask, time, bwd: str = "pallas_split"
                             ) -> torch.Tensor:
  """Dynamic aggregator; arguments as DynamicAggregator.forward.  bwd: the
  training route on the card, "pallas_split" (K3r; K4a + K4b) or "pallas"
  (K3p; K4s); both take the twin on the CPU."""
  check_route("fused_bwd_impl", bwd, DYNAMIC_BWD_ROUTES)
  if not rgb_feat.is_cuda:
    return net(pts, rgb_feat, glb_ray_dir, mask, time)
  return _dynamic_cuda(net, pts, rgb_feat, glb_ray_dir, mask, time, bwd)


def _dynamic_cuda(net, pts, rgb_feat, glb_ray_dir, mask, time,
                  bwd: str = "pallas_split"):
  dirfeat, dirpe = _dir_inputs(net, glb_ray_dir, time)
  if torch.is_grad_enabled():
    fn = _DynamicAggSingleFn if bwd == "pallas" else _DynamicAggFn
    return fn.apply(net, pts, dirfeat, dirpe, rgb_feat, mask,
                    *kernel_params(net, False))
  out, _ = _dynamic_launch(net, pts, dirfeat, dirpe, rgb_feat, mask)
  fused_dynamic_aggregator.launches += 1
  return out


def static_forward_residuals(net, pts, reffeat, src_pl, rgb_feat, ray_diff,
                             mask):
  """K2r: K2 with its workspaces kept for the backward."""
  out, ws = _static_launch(net, pts, reffeat, src_pl, rgb_feat, ray_diff,
                           mask)
  static_forward_residuals.launches += 1
  return out, ws


def dynamic_forward_residuals(net, pts, dirfeat, dirpe, rgb_feat, mask):
  """K3r: K3 with its workspaces kept for the backward."""
  out, ws = _dynamic_launch(net, pts, dirfeat, dirpe, rgb_feat, mask)
  dynamic_forward_residuals.launches += 1
  return out, ws


def dynamic_forward_primal(net, pts, dirfeat, dirpe, rgb_feat, mask):
  """K3p: the K3 launch under the "pallas" route, which keeps no residuals:
  returns raw and the converted inputs K4s reads (any S: K4s masks a ray's
  last 64-point trunk block at the ray's end)."""
  out, ws = _dynamic_launch(net, pts, dirfeat, dirpe, rgb_feat, mask)
  dynamic_forward_primal.launches += 1
  return out, {k: ws[k] for k in ("pts", "dirfeat", "dirpe", "posenc",
                                  "rgb_feat", "mask")}


# --------------------------------------------------------------------------
# backward launches (K4a/K4b, K5a/K5b, K5c/K5d)
# --------------------------------------------------------------------------

def static_backward_ray(net, ws, cot, slabs, nblk, w_total):
  """K5a: ray-side static backward.  Returns d_x [V,P,128] bf16 and
  d_misc [V,P,8] (d_vis | d_rgb | d_ray_diff); weight grads go to the
  slabs.  Reads the tiled weights (``pack_tiled``)."""
  dev = cot.device
  r, s, v, c = ws["rgb_feat"].shape
  _, b, meta = pack_weights(net, True)
  f32 = dict(dtype=torch.float32, device=dev)
  dx = torch.empty((v, r * s, 128), dtype=torch.bfloat16, device=dev)
  dmisc = torch.zeros((v, r * s, 8), **f32)
  scratch = torch.empty((nblk, _MAX_SAMPLES, _SCRATCH_LD), **f32)
  stats = torch.empty((nblk, 12, _MAX_SAMPLES), **f32)
  fn = _fn("static_agg_bwd", "dyn_static_agg_bwd_ray", _ST_RAY_ARGS)
  build.check(fn(pack_tiled(net, True).data_ptr(), b.data_ptr(),
                 _meta_ptr(meta), ws["gf"].data_ptr(), ws["x"].data_ptr(),
                 ws["vm"][0].data_ptr(), ws["vm"][1].data_ptr(),
                 cot.data_ptr(), ws["ray_diff"].data_ptr(),
                 ws["rgb_feat"].data_ptr(), dx.data_ptr(), dmisc.data_ptr(),
                 scratch.data_ptr(), stats.data_ptr(), slabs.data_ptr(),
                 slabs.shape[1], w_total, r, s, v, c, nblk, _stream(dev)),
              "static aggregator backward (ray)")
  static_backward_ray.launches += 1
  return dx, dmisc


def static_backward_trunk(net, ws, dx, dmisc, slabs, nblk, w_total):
  """K5b: trunk-side static backward, then the slab reduction.  Returns
  the packed f32 gradients and the input cotangents.  Reads the tiled
  weights (``pack_tiled``)."""
  dev = dx.device
  r, s, v, c = ws["rgb_feat"].shape
  p = r * s
  if c > _MAX_CH_STATIC_BWD:
    raise ValueError(f"static backward kernel limit 3+C<={_MAX_CH_STATIC_BWD}"
                     f"; got {c}")
  _, b, meta = pack_weights(net, True)
  f32 = dict(dtype=torch.float32, device=dev)
  drf = torch.empty((v, p, 2 * c), **f32)
  dgf = torch.empty((nblk, 64, _TRUNK_LDF), **f32)
  out = dict(rgb_feat=torch.empty((p, v, c), **f32),
             ray_diff=torch.empty((p, v, 4), **f32),
             src_pl=torch.empty((p, v, 6), **f32),
             pts=torch.empty((p, 3), **f32),
             reffeat=torch.empty((p, c), **f32),
             s=torch.empty((p,), **f32))
  fn = _fn("static_agg_bwd", "dyn_static_agg_bwd_trunk", _ST_TRUNK_ARGS)
  build.check(fn(pack_tiled(net, True).data_ptr(), b.data_ptr(),
                 _meta_ptr(meta),
                 ws["rgb_feat"].data_ptr(), ws["mask"].data_ptr(),
                 ws["pts"].data_ptr(), ws["reffeat"].data_ptr(),
                 ws["ray_diff"].data_ptr(), ws["src_pl"].data_ptr(),
                 ws["rf"].data_ptr(), int(net.anti_alias_pooling),
                 int(net.mask_rgb), dx.data_ptr(), dmisc.data_ptr(),
                 drf.data_ptr(), dgf.data_ptr(), out["rgb_feat"].data_ptr(),
                 out["ray_diff"].data_ptr(), out["src_pl"].data_ptr(),
                 out["pts"].data_ptr(), out["reffeat"].data_ptr(),
                 out["s"].data_ptr(), slabs.data_ptr(), slabs.shape[1],
                 w_total, r, s, v, c, nblk, _stream(dev)),
              "static aggregator backward (trunk)")
  grads = _reduce("static_agg_bwd", slabs)
  static_backward_trunk.launches += 1
  return grads, out


def static_backward_trunk3(net, ws, dx, dmisc, slabs, nblk, w_total):
  """K5c: the static trunk-side backward without the input MLP.  Returns
  d_rf_tot [V,P,2C] f32, d_dot [V,P] (the anti-alias cotangent of
  ray_diff[..., 3]) and d_s [P]; weight grads go to the slabs."""
  dev = dx.device
  r, s, v, c = ws["rgb_feat"].shape
  p = r * s
  if c > _MAX_CH_STATIC_BWD:
    raise ValueError(f"static backward kernel limit 3+C<={_MAX_CH_STATIC_BWD}"
                     f"; got {c}")
  _, b, meta = pack_weights(net, True)
  f32 = dict(dtype=torch.float32, device=dev)
  drf = torch.empty((v, p, 2 * c), **f32)
  d_dot = torch.empty((v, p), **f32)
  d_s = torch.empty((p,), **f32)
  fn = _fn("static_agg_bwd3", "dyn_static_agg_bwd_trunk3", _ST_TRUNK3_ARGS)
  build.check(fn(pack_frag(net, True).data_ptr(),
                 pack_frag_t(net, True).data_ptr(), b.data_ptr(),
                 _meta_ptr(meta),
                 ws["rgb_feat"].data_ptr(), ws["mask"].data_ptr(),
                 ws["ray_diff"].data_ptr(), ws["rf"].data_ptr(),
                 int(net.anti_alias_pooling), int(net.mask_rgb),
                 dx.data_ptr(), dmisc.data_ptr(), drf.data_ptr(),
                 d_dot.data_ptr(), d_s.data_ptr(), slabs.data_ptr(),
                 slabs.shape[1], w_total, r, s, v, c, nblk, _stream(dev)),
              "static aggregator backward (trunk, split3)")
  static_backward_trunk3.launches += 1
  return drf, d_dot, d_s


def static_backward_inmlp(net, ws, drf, dmisc, d_dot, slabs, nblk, w_total):
  """K5d: the per-view input MLP's backward, then the slab reduction.
  Returns the packed f32 gradients and the input cotangents (as
  static_backward_trunk's, without ``s``).  Two blocks of 256 threads fit
  an SM: the grid is 2 · nblk persistent blocks.  Reads the fragment-major
  weights and transposes (``pack_frag``, ``pack_frag_t``)."""
  dev = drf.device
  r, s, v, c = ws["rgb_feat"].shape
  p = r * s
  _, b, meta = pack_weights(net, True)
  f32 = dict(dtype=torch.float32, device=dev)
  out = dict(rgb_feat=torch.empty((p, v, c), **f32),
             ray_diff=torch.empty((p, v, 4), **f32),
             src_pl=torch.empty((p, v, 6), **f32),
             pts=torch.empty((p, 3), **f32),
             reffeat=torch.empty((p, c), **f32))
  fn = _fn("static_agg_bwd3", "dyn_static_agg_bwd_inmlp", _ST_INMLP_ARGS)
  build.check(fn(pack_frag(net, True).data_ptr(),
                 pack_frag_t(net, True).data_ptr(), b.data_ptr(),
                 _meta_ptr(meta), ws["pts"].data_ptr(),
                 ws["reffeat"].data_ptr(), ws["ray_diff"].data_ptr(),
                 ws["src_pl"].data_ptr(),
                 drf.data_ptr(), dmisc.data_ptr(), d_dot.data_ptr(),
                 out["rgb_feat"].data_ptr(), out["ray_diff"].data_ptr(),
                 out["src_pl"].data_ptr(), out["pts"].data_ptr(),
                 out["reffeat"].data_ptr(), slabs.data_ptr(), slabs.shape[1],
                 w_total, r, s, v, c, 2 * nblk, _stream(dev)),
              "static aggregator backward (input MLP, split3)")
  grads = _reduce("static_agg_bwd3", slabs)
  static_backward_inmlp.launches += 1
  return grads, out


def static_backward(net, ws, cot, bwd: str):
  """The whole static backward on route `bwd`: K5a, then K5b or K5c + K5d.
  Frees the residuals as it goes.  Returns the packed f32 gradients and
  the input cotangents (``s`` per point)."""
  slabs, nblk, w_total = _slabs(cot.device, pack_weights(net, True))
  dx, dmisc = static_backward_ray(net, ws, cot, slabs, nblk, w_total)
  for k in ("x", "vm", "gf", "nv"):    # the ray side's residuals
    del ws[k]
  if bwd == "pallas_split3":
    drf, d_dot, d_s = static_backward_trunk3(net, ws, dx, dmisc, slabs,
                                             nblk, w_total)
    del dx, ws["rf"]
    grads, d = static_backward_inmlp(net, ws, drf, dmisc, d_dot, slabs, nblk,
                                     w_total)
    d["s"] = d_s
  elif bwd == "pallas_split":
    grads, d = static_backward_trunk(net, ws, dx, dmisc, slabs, nblk,
                                     w_total)
  else:
    raise NotImplementedError(bwd)
  return grads, d


def dynamic_backward_ray(net, ws, cot, slabs, nblk, w_total):
  """K4a: ray-side dynamic backward.  Returns d_x, d_misc (d_vis in slot
  0), d_pts [P,3] and d_dirpe [R,27].  Reads the tiled weights
  (``pack_tiled``)."""
  dev = cot.device
  r, s, v, c = ws["rgb_feat"].shape
  _, b, meta = pack_weights(net, False)
  f32 = dict(dtype=torch.float32, device=dev)
  dx = torch.empty((v, r * s, 128), dtype=torch.bfloat16, device=dev)
  dmisc = torch.zeros((v, r * s, 8), **f32)
  d_pts = torch.empty((r * s, 3), **f32)
  d_dirpe = torch.empty((r, 27), **f32)
  scratch = torch.empty((nblk, _MAX_SAMPLES, _SCRATCH_LD), **f32)
  stats = torch.empty((nblk, 12, _MAX_SAMPLES), **f32)
  fn = _fn("dynamic_agg_bwd", "dyn_dynamic_agg_bwd_ray", _DYN_RAY_ARGS)
  build.check(fn(pack_tiled(net, False).data_ptr(), b.data_ptr(),
                 _meta_ptr(meta), ws["gf"].data_ptr(), ws["x"].data_ptr(),
                 ws["vm"][0].data_ptr(), ws["vm"][1].data_ptr(),
                 cot.data_ptr(), ws["posenc"].data_ptr(),
                 ws["pts"].data_ptr(), ws["dirpe"].data_ptr(), dx.data_ptr(),
                 dmisc.data_ptr(), d_pts.data_ptr(), d_dirpe.data_ptr(),
                 scratch.data_ptr(), stats.data_ptr(), slabs.data_ptr(),
                 slabs.shape[1], w_total, r, s, v, c, nblk, _stream(dev)),
              "dynamic aggregator backward (ray)")
  dynamic_backward_ray.launches += 1
  return dx, dmisc, d_pts, d_dirpe


def dynamic_backward_trunk(net, ws, dx, dmisc, slabs, nblk, w_total):
  """K4b: trunk-side dynamic backward, then the slab reduction.  Returns
  the packed f32 gradients, d_rgb_feat [P,V,C] and d_dirfeat [P,C].  Reads
  the fragment-major weights and transposes (``pack_frag``,
  ``pack_frag_t``)."""
  dev = dx.device
  r, s, v, c = ws["rgb_feat"].shape
  p = r * s
  _, b, meta = pack_weights(net, False)
  f32 = dict(dtype=torch.float32, device=dev)
  drf = torch.empty((v, p, c), **f32)
  d_rgbfeat = torch.empty((p, v, c), **f32)
  d_dirfeat = torch.empty((p, c), **f32)
  fn = _fn("dynamic_agg_bwd", "dyn_dynamic_agg_bwd_trunk", _DYN_TRUNK_ARGS)
  build.check(fn(pack_frag(net, False).data_ptr(),
                 pack_frag_t(net, False).data_ptr(), b.data_ptr(),
                 _meta_ptr(meta),
                 ws["rgb_feat"].data_ptr(), ws["mask"].data_ptr(),
                 ws["dirfeat"].data_ptr(), dx.data_ptr(), dmisc.data_ptr(),
                 drf.data_ptr(), d_rgbfeat.data_ptr(), d_dirfeat.data_ptr(),
                 slabs.data_ptr(), slabs.shape[1], w_total, r, s, v, c, nblk,
                 _stream(dev)), "dynamic aggregator backward (trunk)")
  grads = _reduce("dynamic_agg_bwd", slabs)
  dynamic_backward_trunk.launches += 1
  return grads, d_rgbfeat, d_dirfeat


def dynamic_backward_single(net, ins, cot):
  """K4s: the whole dynamic backward in one launch from K3p's inputs, then
  the slab reduction.  Returns the packed f32 gradients, d_pts [P,3],
  d_dirpe [R,27], d_rgb_feat [P,V,C] and d_dirfeat [P,C].  One ray per
  persistent block at a time, its workspaces in a per-block scratch.
  Reads the tiled weights (the ray phase, ``pack_tiled``) and the
  fragment-major ones (the trunk phases, ``pack_frag``, ``pack_frag_t``)."""
  dev = cot.device
  r, s, v, c = ins["rgb_feat"].shape
  p = r * s
  packed = pack_weights(net, False)
  _, b, meta = packed
  slabs, nblk, w_total = _slabs(dev, packed)
  f32 = dict(dtype=torch.float32, device=dev)
  bf = dict(dtype=torch.bfloat16, device=dev)
  scratch = dict(x=torch.empty((nblk, v, s, 128), **bf),
                 dx=torch.empty((nblk, v, s, 128), **bf),
                 vm=torch.empty((nblk, 2, v, s), **f32),
                 gf=torch.empty((nblk, s, 128), **f32),
                 nv=torch.empty((nblk, s), **f32),
                 dmisc=torch.empty((nblk, v, s, 8), **f32),
                 drf=torch.empty((nblk, v, s, c), **f32),
                 ray=torch.empty((nblk, _MAX_SAMPLES, _SCRATCH_LD), **f32),
                 stats=torch.empty((nblk, 12, _MAX_SAMPLES), **f32))
  d_pts = torch.empty((p, 3), **f32)
  d_dirpe = torch.empty((r, 27), **f32)
  d_rgbfeat = torch.empty((p, v, c), **f32)
  d_dirfeat = torch.empty((p, c), **f32)
  fn = _fn("dynamic_agg_bwd1", "dyn_dynamic_agg_bwd_single", _DYN_SINGLE_ARGS)
  build.check(fn(pack_tiled(net, False).data_ptr(),
                 pack_frag(net, False).data_ptr(),
                 pack_frag_t(net, False).data_ptr(), b.data_ptr(),
                 _meta_ptr(meta),
                 *(ins[k].data_ptr() for k in ("pts", "dirfeat", "dirpe",
                                               "posenc", "rgb_feat", "mask")),
                 cot.data_ptr(),
                 *(scratch[k].data_ptr() for k in ("x", "dx", "vm", "gf", "nv",
                                                   "dmisc", "drf", "ray",
                                                   "stats")),
                 d_pts.data_ptr(), d_dirpe.data_ptr(), d_rgbfeat.data_ptr(),
                 d_dirfeat.data_ptr(), slabs.data_ptr(), slabs.shape[1],
                 w_total, r, s, v, c, nblk, _stream(dev)),
              "dynamic aggregator backward (single kernel)")
  grads = _reduce("dynamic_agg_bwd1", slabs)
  dynamic_backward_single.launches += 1
  return grads, d_pts, d_dirpe, d_rgbfeat, d_dirfeat


def _reduce(lib: str, slabs: torch.Tensor) -> torch.Tensor:
  out = torch.empty((slabs.shape[1],), dtype=torch.float32,
                    device=slabs.device)
  fn = _fn(lib, "dyn_agg_reduce", _REDUCE_ARGS)
  build.check(fn(slabs.data_ptr(), slabs.shape[0], slabs.shape[1],
                 out.data_ptr(), _stream(slabs.device)), "gradient reduce")
  return out


class _StaticAggFn(torch.autograd.Function):
  """K2r forward, K5a + K5b (route "pallas_split") or K5a + K5c + K5d
  ("pallas_split3") backward.  Inputs after ``net`` and the route: pts
  [R,S,3], reffeat [R,C] (ref_feature_fc output), src_pl, rgb_feat,
  ray_diff, mask, then ``kernel_params(net, True)``."""

  @staticmethod
  def forward(ctx, net, bwd, pts, reffeat, src_pl, rgb_feat, ray_diff, mask,
              *params):
    out, ws = static_forward_residuals(net, pts, reffeat, src_pl, rgb_feat,
                                       ray_diff, mask)
    ctx.net, ctx.ws, ctx.bwd = net, ws, bwd
    ctx.dtypes = (pts.dtype, reffeat.dtype, src_pl.dtype, rgb_feat.dtype,
                  ray_diff.dtype)
    return out

  @staticmethod
  def backward(ctx, d_out):
    net, ws = ctx.net, ctx.ws
    ctx.ws = None                      # residuals go with this backward
    r, s, v, c = ws["rgb_feat"].shape
    grads, d = static_backward(net, ws, d_out.float().contiguous(), ctx.bwd)
    del ws
    w, _, meta = pack_weights(net, True)
    d_s = d["s"].sum() if net.anti_alias_pooling else None
    dt = ctx.dtypes
    return (None, None, d["pts"].view(r, s, 3).to(dt[0]),
            d["reffeat"].view(r, s, c).sum(1).to(dt[1]),
            d["src_pl"].view(r, s, v, 6).to(dt[2]),
            d["rgb_feat"].view(r, s, v, c).to(dt[3]),
            d["ray_diff"].view(r, s, v, 4).to(dt[4]), None,
            *unpack_grads(net, True, meta, grads, w.numel(), d_s))


class _DynamicAggFn(torch.autograd.Function):
  """K3r forward, K4a + K4b backward.  Inputs after ``net``: pts [R,S,3],
  dirfeat [R,S,C] (time ray_dir_fc output), dirpe [R,27], rgb_feat, mask,
  then ``kernel_params(net, False)``."""

  @staticmethod
  def forward(ctx, net, pts, dirfeat, dirpe, rgb_feat, mask, *params):
    out, ws = dynamic_forward_residuals(net, pts, dirfeat, dirpe, rgb_feat,
                                        mask)
    ctx.net, ctx.ws = net, ws
    ctx.dtypes = (pts.dtype, dirfeat.dtype, dirpe.dtype, rgb_feat.dtype)
    return out

  @staticmethod
  def backward(ctx, d_out):
    net, ws = ctx.net, ctx.ws
    ctx.ws = None
    r, s, v, c = ws["rgb_feat"].shape
    cot = d_out.float().contiguous()
    slabs, nblk, w_total = _slabs(cot.device, pack_weights(net, False))
    dx, dmisc, d_pts, d_dirpe = dynamic_backward_ray(net, ws, cot, slabs,
                                                     nblk, w_total)
    for k in ("x", "vm", "gf", "nv"):
      del ws[k]
    grads, d_rgbfeat, d_dirfeat = dynamic_backward_trunk(
        net, ws, dx, dmisc, slabs, nblk, w_total)
    del ws, dx, dmisc, slabs
    meta = pack_weights(net, False)[2]
    dt = ctx.dtypes
    return (None, d_pts.view(r, s, 3).to(dt[0]),
            d_dirfeat.view(r, s, c).to(dt[1]), d_dirpe.to(dt[2]),
            d_rgbfeat.view(r, s, v, c).to(dt[3]), None,
            *unpack_grads(net, False, meta, grads, w_total, None))


class _DynamicAggSingleFn(torch.autograd.Function):
  """K3p forward, K4s backward (route "pallas"): the forward keeps only its
  inputs, as ``_make_dyn_core_diff`` does (pallas_agg.py:907-965).  Inputs
  as ``_DynamicAggFn``'s."""

  @staticmethod
  def forward(ctx, net, pts, dirfeat, dirpe, rgb_feat, mask, *params):
    out, ins = dynamic_forward_primal(net, pts, dirfeat, dirpe, rgb_feat,
                                      mask)
    ctx.net, ctx.ins = net, ins
    ctx.dtypes = (pts.dtype, dirfeat.dtype, dirpe.dtype, rgb_feat.dtype)
    return out

  @staticmethod
  def backward(ctx, d_out):
    net, ins = ctx.net, ctx.ins
    ctx.ins = None
    r, s, v, c = ins["rgb_feat"].shape
    grads, d_pts, d_dirpe, d_rgbfeat, d_dirfeat = dynamic_backward_single(
        net, ins, d_out.float().contiguous())
    del ins
    w, _, meta = pack_weights(net, False)
    dt = ctx.dtypes
    return (None, d_pts.view(r, s, 3).to(dt[0]),
            d_dirfeat.view(r, s, c).to(dt[1]), d_dirpe.to(dt[2]),
            d_rgbfeat.view(r, s, v, c).to(dt[3]), None,
            *unpack_grads(net, False, meta, grads, w.numel(), None))


for _f in (fused_static_aggregator, fused_dynamic_aggregator,
           static_forward_residuals, dynamic_forward_residuals,
           dynamic_forward_primal, static_backward_ray,
           static_backward_trunk, static_backward_trunk3,
           static_backward_inmlp, dynamic_backward_ray,
           dynamic_backward_trunk, dynamic_backward_single):
  _f.launches = 0


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
  """Matmul flops of the static input MLP ray_dir_fc's forward, the part
  of the trunk side that K5d (not K5c) transposes."""
  return 2 * r * s * v * _mlp_macs((103, 256, c))


def aggregator_flops(static: bool, r: int, s: int, v: int, c: int) -> int:
  """Matmul flops of the whole forward (K2/K3) for these shapes."""
  return sum(aggregator_flop_parts(static, r, s, v, c))
