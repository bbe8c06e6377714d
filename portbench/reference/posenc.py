"""Frozen copy of dynibar_tpu_torch/core/posenc.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

Fourier positional encodings (reference mlp_network.py:530-555).

Layout ``[x, cos(f1 x) .. cos(fN x), sin(f1 x) .. sin(fN x)]`` on the last
axis, each frequency emitting a full copy of the input channels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _freqs(max_freq: int, n_freq: int, linspace: bool) -> np.ndarray:
  """The frequency ladder, shared by every caller: read-only."""
  if linspace:
    out = np.linspace(1.0, max_freq + 1.0, n_freq).astype(np.float32)
  else:
    exps = np.linspace(0.0, n_freq - 1.0, n_freq).astype(np.float32)
    out = (2.0 ** exps).astype(np.float32)
  out.setflags(write=False)
  return out


def periodic_embed(x: torch.Tensor, max_freq: int, n_freq: int,
                   linspace: bool = True) -> torch.Tensor:
  """[..., C] -> [..., C * (2 * n_freq + 1)]."""
  # a copy: a tensor aliasing the cached table would let one caller's
  # in-place op change every later embedding
  freqs = torch.tensor(_freqs(max_freq, n_freq, linspace), device=x.device,
                       dtype=x.dtype)
  xs = x[..., None, :] * freqs[:, None]                  # [..., F, C]
  shape = x.shape[:-1] + (n_freq * x.shape[-1],)
  return torch.cat([x, torch.cos(xs).reshape(shape),
                    torch.sin(xs).reshape(shape)], dim=-1)


@functools.lru_cache(maxsize=None)
def sample_axis_posenc(d_hid: int, n_samples: int) -> np.ndarray:
  """Sinusoid table over the sample axis (reference mlp_network.py:220-234):
  ``table[pos, 2i] = sin(pos / 10000^(2i/d))``, ``[pos, 2i+1] = cos(..)``."""
  pos = np.arange(n_samples)[:, None].astype(np.float64)
  hid = np.arange(d_hid)[None, :]
  angle = pos / np.power(10000.0, 2.0 * (hid // 2) / d_hid)
  table = np.zeros((n_samples, d_hid), dtype=np.float64)
  table[:, 0::2] = np.sin(angle[:, 0::2])
  table[:, 1::2] = np.cos(angle[:, 1::2])
  return table.astype(np.float32)
