"""K1: bilinear sampling of per-view maps at normalized points.

Replaces ``dynibar_tpu/ops/pallas_sample.py:60 _sample_kernel`` (launched by
``pallas_bilinear_sample_views``).  Semantics are
``F.grid_sample(align_corners=True, padding_mode='zeros')``: exact for
every sample, with no window and no coverage mask.

Two entries launch the one CUDA kernel (csrc/sample.cu) for CUDA tensors
and use their plain twins for CPU tensors:

  * ``sample_views_pair`` (the eval path, ``core/projection.py``): a view
    set's RGB and feature maps at the same points, written as ``rgb_feat``
    [R,S,V,3+C] in the layout the aggregators read, in one launch;
  * ``sample_views``: one map, [V,R,S,C].

``sample_views.launches`` counts K1's launches through either entry.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dynibar_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_VIEWS_ARGS = [_P] * 3 + [_I] * 6 + [_P]
_PAIR_ARGS = [_P] + [_I] * 3 + [_P] + [_I] * 3 + [_P] * 2 + [_I] * 3 + [_P]
_INT32_MAX = 2 ** 31 - 1


def sample_views_plain(maps: torch.Tensor, grid: torch.Tensor
                       ) -> torch.Tensor:
  """maps [V,H,W,C], grid [V,R,S,2] (x, y in [-1, 1]) -> [V,R,S,C].

  Interpolates in f32 and rounds once to the maps' dtype."""
  v, r, s, _ = grid.shape
  out = F.grid_sample(maps.permute(0, 3, 1, 2).float(),
                      grid.reshape(v, r * s, 1, 2).float(), mode="bilinear",
                      padding_mode="zeros", align_corners=True)  # [V,C,N,1]
  return out[..., 0].permute(0, 2, 1).reshape(v, r, s, -1).to(maps.dtype)


def sample_views_pair_plain(rgbs: torch.Tensor, feats: torch.Tensor,
                            grid: torch.Tensor) -> torch.Tensor:
  """rgbs [V,H,W,3], feats [V,Hf,Wf,C], grid [V,R,S,2] -> rgb_feat
  [R,S,V,3+C]: both maps at the same normalized points (align_corners=True
  serves both resolutions), each rounded once to its dtype."""
  return torch.cat([sample_views_plain(rgbs, grid),
                    sample_views_plain(feats, grid)],
                   dim=-1).permute(1, 2, 0, 3).contiguous()


def _check_maps(grid: torch.Tensor, *maps: torch.Tensor) -> None:
  v = maps[0].shape[0]
  for m in maps:
    if m.dim() != 4 or m.shape[0] != v:
      raise ValueError(f"maps {tuple(m.shape)}: expected [V={v},H,W,C]")
    if m.dtype not in (torch.float32, torch.bfloat16):
      raise ValueError(f"maps dtype {m.dtype} not supported")
    if m.dtype != maps[0].dtype or m.device != maps[0].device:
      raise ValueError("the maps must share one dtype and device")
    if not m.is_contiguous():
      raise ValueError("maps must be contiguous")
    if m.numel() > _INT32_MAX:
      raise ValueError("the kernel addresses a map with 32-bit offsets")
  if grid.device != maps[0].device or grid.dtype != torch.float32:
    raise ValueError("grid must be f32 on the maps' device")
  if grid.dim() != 4 or grid.shape[0] != v or grid.shape[-1] != 2:
    raise ValueError(f"grid {tuple(grid.shape)} does not fit maps "
                     f"{tuple(maps[0].shape)}")
  if not grid.is_contiguous():
    raise ValueError("grid must be contiguous")
  if torch.is_grad_enabled() and any(t.requires_grad for t in (*maps, grid)):
    raise RuntimeError("K1 has no backward: differentiate through "
                       "sample_views_plain (F.grid_sample)")


def _launch(name: str, argtypes, out: torch.Tensor, *args) -> torch.Tensor:
  if out.numel() > _INT32_MAX:
    raise ValueError("the kernel addresses its output with 32-bit offsets")
  fn = getattr(build.load("sample"), name)
  fn.argtypes, fn.restype = argtypes, ctypes.c_int
  stream = torch.cuda.current_stream(out.device).cuda_stream
  build.check(fn(*args, int(out.dtype == torch.bfloat16), stream), name)
  sample_views.launches += 1
  return out


def sample_views(maps: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
  """K1 on one map: the CUDA kernel for CUDA tensors, the plain twin on
  CPU."""
  if not maps.is_cuda:
    return sample_views_plain(maps, grid)
  _check_maps(grid, maps)
  v, h, w, c = maps.shape
  _, r, s, _ = grid.shape
  out = torch.empty((v, r, s, c), dtype=maps.dtype, device=maps.device)
  return _launch("dyn_sample_views", _VIEWS_ARGS, out, maps.data_ptr(),
                 grid.data_ptr(), out.data_ptr(), v, h, w, c, r * s)


def sample_views_pair(rgbs: torch.Tensor, feats: torch.Tensor,
                      grid: torch.Tensor) -> torch.Tensor:
  """K1 on a view set's two maps in one launch, written in the
  aggregators' layout: the CUDA kernel for CUDA tensors, the plain twin
  (``sample_views_pair_plain``) on CPU."""
  if not rgbs.is_cuda:
    return sample_views_pair_plain(rgbs, feats, grid)
  _check_maps(grid, rgbs, feats)
  v, ha, wa, ca = rgbs.shape
  _, hb, wb, cb = feats.shape
  _, r, s, _ = grid.shape
  out = torch.empty((r, s, v, ca + cb), dtype=rgbs.dtype, device=rgbs.device)
  return _launch("dyn_sample_pair", _PAIR_ARGS, out, rgbs.data_ptr(), ha,
                 wa, ca, feats.data_ptr(), hb, wb, cb, grid.data_ptr(),
                 out.data_ptr(), v, r * s)


sample_views.launches = 0
