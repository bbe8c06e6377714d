"""Frozen copy of dynibar_tpu_torch/models/attention.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

Ray transformer: 4-head attention along the sample axis.

Reference ``MultiHeadAttention`` (ibrnet/mlp_network.py:13-104): d_model
128, d_k = d_v = 32, no-bias projections, residual + LayerNorm(eps=1e-6).
The [B, L, 1] mask masks query ROWS (masked_fill of the whole row with
-1e9), so an invalid query attends uniformly; keys are never masked.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class RayTransformer(nn.Module):

  def __init__(self, n_head: int = 4, d_model: int = 128, d_k: int = 32,
               d_v: int = 32):
    super().__init__()
    self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
    self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
    self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
    self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
    self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
    self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

  def forward(self, q, k, v, mask=None):
    """q/k/v [B, L, d_model]; mask [B, L, 1] (1 = valid query) or None."""
    b, lq = q.shape[:2]
    residual = q
    qh = self.w_qs(q).view(b, lq, self.n_head, self.d_k).transpose(1, 2)
    kh = self.w_ks(k).view(b, -1, self.n_head, self.d_k).transpose(1, 2)
    vh = self.w_vs(v).view(b, -1, self.n_head, self.d_v).transpose(1, 2)
    attn = torch.matmul(qh / self.d_k ** 0.5, kh.transpose(2, 3))
    if mask is not None:
      attn = attn.masked_fill(mask[:, None] == 0, -1e9)
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn, vh).transpose(1, 2).reshape(b, lq, -1)
    return self.layer_norm(self.fc(out) + residual)
