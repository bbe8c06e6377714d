"""K1: bilinear sampling of per-view maps at normalized points.

Replaces ``dynibar_tpu/ops/pallas_sample.py:60 _sample_kernel`` (launched by
``pallas_bilinear_sample_views``).  Semantics are
``F.grid_sample(align_corners=True, padding_mode='zeros')``: exact for
every sample, with no window and no coverage mask.

``sample_views`` launches the CUDA kernel (csrc/sample.cu) for CUDA
tensors and uses the plain twin ``sample_views_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dynibar_tpu_torch.ops import build

_C_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
           ctypes.c_int, ctypes.c_void_p]


def sample_views_plain(maps: torch.Tensor, grid: torch.Tensor
                       ) -> torch.Tensor:
  """maps [V,H,W,C], grid [V,R,S,2] (x, y in [-1, 1]) -> [V,R,S,C].

  Interpolates in f32 and rounds once to the maps' dtype."""
  v, r, s, _ = grid.shape
  out = F.grid_sample(maps.permute(0, 3, 1, 2).float(),
                      grid.reshape(v, r * s, 1, 2).float(), mode="bilinear",
                      padding_mode="zeros", align_corners=True)  # [V,C,N,1]
  return out[..., 0].permute(0, 2, 1).reshape(v, r, s, -1).to(maps.dtype)


def sample_views(maps: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
  """K1 wrapper: the CUDA kernel for CUDA tensors, the plain twin on CPU."""
  if not maps.is_cuda:
    return sample_views_plain(maps, grid)
  v, h, w, c = maps.shape
  if grid.device != maps.device or grid.dtype != torch.float32:
    raise ValueError("grid must be f32 on the maps' device")
  if grid.shape[0] != v or grid.shape[-1] != 2 or grid.dim() != 4:
    raise ValueError(f"grid {tuple(grid.shape)} does not fit maps "
                     f"{tuple(maps.shape)}")
  if maps.dtype not in (torch.float32, torch.bfloat16):
    raise ValueError(f"maps dtype {maps.dtype} not supported")
  if not (maps.is_contiguous() and grid.is_contiguous()):
    raise ValueError("maps and grid must be contiguous")
  lib = build.load("sample")
  fn = lib.dyn_sample_views
  fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
  _, r, s, _ = grid.shape
  out = torch.empty((v, r, s, c), dtype=maps.dtype, device=maps.device)
  stream = torch.cuda.current_stream(maps.device).cuda_stream
  build.check(fn(maps.data_ptr(), grid.data_ptr(), out.data_ptr(), v, h, w,
                 c, r * s, int(maps.dtype == torch.bfloat16), stream),
              "sample_views")
  sample_views.launches += 1
  return out


sample_views.launches = 0
