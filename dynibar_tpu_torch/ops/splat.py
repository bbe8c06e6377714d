"""Softmax forward splatting (point-cloud warp to a virtual view).

Port of ``dynibar_tpu.ops.splat``, which replaces the external CUDA
``splatting.splatting_function('softmax', ...)`` of the reference
preprocessing (render_source_vv.py:12,58-60) with a scatter-add: every
source pixel lands bilinearly on 4 target pixels, importance-weighted by
exp(importance); the result is the importance-softmax-weighted average of
the contributing values.

  num[q]  = Σ_p  w_bilinear(p→q) · exp(imp_p) · val_p
  den[q]  = Σ_p  w_bilinear(p→q) · exp(imp_p)
  out[q]  = num[q] / den[q]          (0 where den == 0)

The JAX package computes it as an XLA scatter, outside any Pallas kernel,
so here it is plain PyTorch on whatever device the tensors lie on
(``index_add_``).  On the card the f32 atomics add in no fixed order: the
result differs from the CPU's in the last bits.
"""

from __future__ import annotations

import torch


def softmax_splat(values: torch.Tensor, flow: torch.Tensor,
                  importance: torch.Tensor) -> torch.Tensor:
  """Splat `values` along `flow` with softmax importance weighting.

  Args:
    values:     [H, W, C] source pixel payload (rgb, alpha, ...).
    flow:       [H, W, 2] target = (x + flow_x, y + flow_y).
    importance: [H, W] log-importance (e.g. scaled inverse depth).

  Returns:
    [H, W, C] splatted image.
  """
  h, w, c = values.shape
  yy, xx = torch.meshgrid(
      torch.arange(h, dtype=flow.dtype, device=flow.device),
      torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
  tx = (xx + flow[..., 0]).reshape(-1)
  ty = (yy + flow[..., 1]).reshape(-1)

  # numerical stabilization of exp(importance)
  imp = torch.exp(importance - importance.max()).reshape(-1)
  vals = values.reshape(-1, c)

  x0 = torch.floor(tx)
  y0 = torch.floor(ty)
  num = torch.zeros((h * w, c), dtype=values.dtype, device=values.device)
  den = torch.zeros((h * w,), dtype=values.dtype, device=values.device)

  for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
    xc = x0 + dx
    yc = y0 + dy
    wgt = (1.0 - (tx - xc).abs()) * (1.0 - (ty - yc).abs())
    valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
    wgt = wgt * valid.to(values.dtype) * imp
    idx = (yc.clamp(0, h - 1).to(torch.int64) * w
           + xc.clamp(0, w - 1).to(torch.int64))
    num.index_add_(0, idx, wgt[:, None] * vals)
    den.index_add_(0, idx, wgt)

  out = torch.where(den[:, None] > 0,
                    num / den[:, None].clamp_min(1e-12),
                    torch.zeros((), dtype=values.dtype, device=values.device))
  return out.reshape(h, w, c)
