"""The reference's arithmetic precision: float32, or the control's fp8.

The reference computes in float32 with TF32 off.  The control of
``correct`` is the same reference one precision below the configuration's
bfloat16, where the configuration computes in bfloat16: every linear
layer of the aggregators reads its input and its weight rounded to
float8 e4m3, the format fp8 matmuls read, and every sampled source map
(images and feature maps) is rounded so.  The rounding passes gradients
straight through, so the control trains as the reference does, on
coarser values.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

_MODE = {"fp8": False}


def set_fp8(on: bool) -> None:
  _MODE["fp8"] = bool(on)


def _fp8(x: torch.Tensor) -> torch.Tensor:
  if not x.is_floating_point():
    return x
  # e4m3 saturates at 448: clamp, then round, gradient straight through
  r = torch.clamp(x.float(), -448.0, 448.0).to(torch.float8_e4m3fn)
  return x + (r.to(x.dtype) - x).detach()


def round_maps(x: torch.Tensor) -> torch.Tensor:
  return _fp8(x) if _MODE["fp8"] else x


def _fp8_linear(m: nn.Linear):
  def forward(x):
    return F.linear(_fp8(x), _fp8(m.weight), m.bias)
  return forward


@contextlib.contextmanager
def hooked(net: nn.Module):
  """Under fp8, each linear layer of ``net`` reads its input and its
  weight rounded to e4m3."""
  if not _MODE["fp8"]:
    yield
    return
  layers = [m for m in net.modules() if isinstance(m, nn.Linear)]
  for m in layers:
    m.forward = _fp8_linear(m)
  try:
    yield
  finally:
    for m in layers:
      del m.forward
