"""The plain twin of the ray transformer's attention (the function the
card tests hold K4a's attention, csrc/attn_mma.cuh, against) vs a float64
softmax attention under autograd.

The float64 side is the reference's rule (mlp_network.py:23-24, as the
JAX bodies apply it, dynibar_tpu/ops/pallas_agg_bwd.py:28-31): a query
with at most one valid view has every logit replaced by -1e9, so it
attends uniformly and no cotangent reaches its logits.  The twin rounds
the exponentials, probabilities and logit cotangents to bf16 before their
products, as the JAX bodies and the kernel do, so it differs from the
float64 run by bf16 rounding: every output within 1e-2 of its tensor's
largest magnitude (two bf16 ulps there), and the row statistics within
1e-5.  Ray 0 has no valid view at any sample, ray 1 one at every sample.
"""

import numpy as np
import pytest
import torch

from dynibar_tpu_torch.utils.kernel_check import (ATTN_FIELDS,
                                                  attention_inputs,
                                                  ray_attention_plain)
from torch_port_threads import one_torch_thread  # noqa: F401


def _float64(q, k, v, d_o, nvalid):
  r, s, _ = q.shape
  qh, kh, vh = [t.double().reshape(r, s, 4, 32).transpose(1, 2)
                .requires_grad_(True) for t in (q, k, v)]
  doh = d_o.double().reshape(r, s, 4, 32).transpose(1, 2)
  x = (qh @ kh.transpose(-1, -2)) / np.sqrt(32.0)
  x = torch.where((nvalid <= 1)[:, None, :, None], -1e9, x)
  m = x.amax(-1, keepdim=True).detach()
  o = torch.softmax(x, -1) @ vh
  (o * doh).sum().backward()
  heads = (o.detach(), qh.grad, kh.grad, vh.grad)
  out = {n: t.transpose(1, 2).reshape(r, s, 128)
         for n, t in zip(ATTN_FIELDS, heads)}
  uni = (nvalid <= 1)[:, None, :]
  out["m"] = torch.where(uni, 0.0, m[..., 0])
  x = x.detach()
  out["l"] = torch.exp(torch.where(uni[..., None], 0.0, x - m)).sum(-1)
  return out


@pytest.mark.parametrize("s,seed", [(16, 0), (48, 1), (64, 2), (128, 3)])
def test_attention_twin_matches_float64(s, seed):
  ins = attention_inputs(torch.device("cpu"), 5, s, seed)
  got = ray_attention_plain(*ins)
  want = _float64(*ins)
  for name in ATTN_FIELDS[:4]:
    w = want[name]
    err = float((got[name].double() - w).abs().max())
    assert err <= 1e-2 * float(w.abs().max()), (name, err)
  for name in ("m", "l"):
    w = want[name]
    err = float((got[name].double() - w).abs().max())
    assert err <= 1e-5 * float(w.abs().max()), (name, err)
  # the masked rays: uniform outputs, no gradient through the logits
  for name in ("dq", "dk"):
    assert float(got[name][:2].float().abs().max()) == 0.0, name
