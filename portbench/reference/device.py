"""Frozen copy of dynibar_tpu_torch/utils/device.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
There is no silent CPU fallback: asking for the default device on a host
without CUDA raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
  """``None`` means the CUDA card; raise when there is none.

  Also pins full-f32 matmuls and convolutions: geometry and the plain
  twins are held to f32 references, and TF32 keeps ~3 decimal digits.
  """
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(
          "CUDA is not available; pass device='cpu' to run the plain "
          "PyTorch path on the CPU")
    if dev.index is None:
      dev = torch.device("cuda", torch.cuda.current_device())
  return dev


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
  """Ray-batch dict (numpy or tensors) -> tensors on `device`.

  Floating arrays become f32; integer arrays keep an integer type."""
  out = {}
  for k, v in batch.items():
    if v is None:
      out[k] = None
      continue
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if t.is_floating_point():
      t = t.to(device=device, dtype=torch.float32)
    else:
      t = t.to(device=device, dtype=torch.int64)
    out[k] = t
  return out
