"""Holding the aggregator kernels against their plain twins.

Used on the card by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
The f32 twin is the module; the bf16 twin (:func:`bf16_twin`) is the
module under ``torch.autocast`` to bf16 on the inputs' device, with
``rgb_feat`` and ``ray_diff`` rounded to bf16 on the way in, as the JAX
package's bf16 twin casts them (``compute_dtype``,
dynibar_tpu/models/aggregators.py).  It runs on the CPU too, where the
renders' ``kernels=BF16_TWIN`` choose it (models/dynibar.py).

Forwards: the bar is the JAX package's (tests/test_pallas_agg.py:93-104,
``test_fused_no_worse_than_flax_bf16``): ``max|kernel - f32| <=
2 max|twin_bf16 - f32| + 1e-3``, apart for the colours and for the
densities that are not -1e9 fills (:func:`forward_errors`).

Gradients: the bar is the JAX package's own
(tests/test_pallas_agg.py:370-377): per tensor, ``max|g_kernel - g_f32| /
max|g_f32|`` must stay within twice the same ratio of the bf16 twin plus
0.02; the twins run under autograd.

The twins run in slices of rays (the aggregators treat rays independently:
input cotangents are cut along rays, weight gradients add up), so the
kernels are checked at the main path's ray counts with the twins' memory
of one slice.

The static anti-alias scalar ``s`` gets one gradient: a sum over every
point of per-point terms of both signs.  Its ratio to ``|g_f32|`` would
swing with how far those terms cancel, so ``s`` is held twice: per point
(``s.per_point``, the gradient each point adds, under the bar above) and as
the sum, with its error scaled by the sum of the f32 terms' magnitudes.

The ray transformer's attention, which K5a, K4a and K4s share
(csrc/attn_mma.cuh), is also held on its own: :func:`ray_attention`
launches it alone and :func:`ray_attention_plain` rounds at the same
points in plain PyTorch.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from dynibar_tpu_torch.ops import agg, build

STATIC_INPUTS = ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff", "mask")
DYNAMIC_INPUTS = ("pts", "rgb_feat", "ray_dir", "mask", "time")
_DIFF_INPUTS = {True: ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff"),
                False: ("pts", "rgb_feat", "ray_dir", "time")}
TWIN_RAYS = 512


def random_inputs(dev, r: int, s: int, v: int, seed: int,
                  c: int = 35) -> Dict[str, torch.Tensor]:
  """Inputs of both aggregators from a seed: [R,S,V,·] layout, ray 0 with
  no valid view and ray 1 with only view 0 valid."""
  g = torch.Generator().manual_seed(seed)
  mask = (torch.rand(r, s, v, 1, generator=g) > 0.3).float()
  mask[0] = 0.0
  mask[1, :, 1:] = 0.0
  mask[1, :, 0] = 1.0
  d = dict(pts=torch.randn(r, s, 3, generator=g),
           ref_pl=torch.randn(r, 6, generator=g),
           src_pl=torch.randn(r, s, v, 6, generator=g),
           rgb_feat=torch.rand(r, s, v, c, generator=g),
           ray_dir=torch.randn(r, 3, generator=g),
           ray_diff=torch.randn(r, s, v, 4, generator=g) * 0.3,
           mask=mask, time=torch.full((r, s, 1), 0.37))
  return {k: t.to(dev) for k, t in d.items()}


def bf16_twin(net: nn.Module, static: bool, args: Sequence[torch.Tensor]
              ) -> torch.Tensor:
  """The aggregator's bf16 twin: ``net`` under ``torch.autocast`` to bf16
  on the inputs' device (CPU or CUDA), ``rgb_feat`` and ``ray_diff``
  rounded to bf16 first; raw [R,S,4] in f32.  Records for autograd when
  grad is enabled."""
  names = STATIC_INPUTS if static else DYNAMIC_INPUTS
  args = [a.to(torch.bfloat16) if n in ("rgb_feat", "ray_diff") else a
          for n, a in zip(names, args)]
  with torch.autocast(args[0].device.type, dtype=torch.bfloat16):
    return net(*args).float()


def forward_errors(got: torch.Tensor, want: torch.Tensor,
                   twin: torch.Tensor) -> Dict[str, Tuple[float, float, float]]:
  """{"colours" | "densities": (max|kernel - f32|, max|twin - f32|, bar)}
  of raw outputs [R,S,4]: the kernel's, the f32 twin's and the bf16
  twin's; the densities where the f32 twin has no -1e9 fill; bar ``2
  twin + 1e-3`` (tests/test_pallas_agg.py:93-104)."""
  keep = want[..., 3] > -1e8
  out = {}
  for part, sel in (("colours", lambda t: t[..., :3]),
                    ("densities", lambda t: t[..., 3][keep])):
    w = sel(want.float())
    if w.numel() == 0:
      out[part] = (0.0, 0.0, 1e-3)
      continue
    ek = float((sel(got.float()) - w).abs().max())
    eb = float((sel(twin.float()) - w).abs().max())
    out[part] = (ek, eb, 2.0 * eb + 1e-3)
  return out


def _has_s(net: nn.Module, static: bool) -> bool:
  return static and net.anti_alias_pooling


def aggregator_grads(net: nn.Module, static: bool,
                     args: Sequence[torch.Tensor], cot: torch.Tensor,
                     mode: str, rays: int = TWIN_RAYS,
                     bwd: str = "pallas_split"
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """One forward + backward of ``sum(raw * cot)``.

  mode: "kernel" (the CUDA kernels through the autograd Function, all rays
  in one call, the backward on route `bwd`), "f32" (the module)
  or "bf16" (:func:`bf16_twin`); the twins run
  ``rays`` rays at a time.  Returns raw and
  the gradients of the differentiable inputs (``input.<name>``) and of
  every parameter (its name in ``net``); for the twins of a static net
  with anti-alias pooling also ``s.per_point`` [R,S]."""
  names = STATIC_INPUTS if static else DYNAMIC_INPUTS
  leaves, call = {}, []
  for name, a in zip(names, args):
    if name in _DIFF_INPUTS[static]:
      a = a.detach().float().clone().requires_grad_(True)
      leaves[name] = a
    call.append(a)
  was = {n: p.requires_grad for n, p in net.named_parameters()}
  net.requires_grad_(True)
  for p in net.parameters():
    p.grad = None
  per_point = []
  s_param = net.s if _has_s(net, static) else None
  try:
    with torch.enable_grad():
      if mode == "kernel":
        if static:
          out = agg.fused_static_aggregator(net, *call, bwd=bwd).float()
        else:
          out = agg.fused_dynamic_aggregator(net, *call, bwd=bwd).float()
        (out * cot).sum().backward()
      elif mode in ("f32", "bf16"):
        outs = []
        for i in range(0, cot.shape[0], rays):
          part = [a[i:i + rays] for a in call]
          if s_param is not None:     # one s per point, each its own grad
            r_, s_ = part[0].shape[:2]
            net.s = nn.Parameter(
                s_param.detach().expand(r_, s_, 1, 1).clone())
          o = (bf16_twin(net, static, part) if mode == "bf16"
               else net(*part).float())
          (o * cot[i:i + rays]).sum().backward()
          outs.append(o.detach())
          if s_param is not None:
            per_point.append(net.s.grad.reshape(r_, s_))
        out = torch.cat(outs)
      else:
        raise ValueError(mode)
    grads = {f"input.{n}": t.grad.detach() for n, t in leaves.items()}
    if per_point:
      grads["s.per_point"] = torch.cat(per_point)
      net.s = s_param
      grads["s"] = grads["s.per_point"].sum().reshape(s_param.shape)
    grads.update({n: p.grad.detach().clone()
                  for n, p in net.named_parameters() if p.grad is not None})
  finally:
    if s_param is not None:
      net.s = s_param
    for n, p in net.named_parameters():
      p.requires_grad_(was[n])
      p.grad = None
  return out.detach(), grads


def kernel_ds_per_point(net: nn.Module, args: Sequence[torch.Tensor],
                        cot: torch.Tensor, bwd: str = "pallas_split"
                        ) -> torch.Tensor:
  """The static kernels' per-point anti-alias gradient [R,S]: K2r and the
  backward of route `bwd` launched directly (the autograd Function sums it
  over points)."""
  pts, ref_pl, src_pl, rgb_feat, ray_diff, mask = args
  r, s = rgb_feat.shape[:2]
  with torch.no_grad():
    reffeat = agg._reffeat(net, ref_pl)
    _, ws = agg.static_forward_residuals(net, pts, reffeat, src_pl, rgb_feat,
                                         ray_diff, mask)
    _, d = agg.static_backward(net, ws, cot.float().contiguous(), bwd)
  return d["s"].view(r, s)


def all_grads(net: nn.Module, static: bool, args: Sequence[torch.Tensor],
              cot: torch.Tensor, rays: int = TWIN_RAYS,
              bwd: str = "pallas_split"):
  """Kernel (the backward on route `bwd`), f32 and bf16 twin:
  (out_k, out_f, g_k, g_f, g_b)."""
  out_k, g_k = aggregator_grads(net, static, args, cot, "kernel", bwd=bwd)
  if _has_s(net, static):
    g_k["s.per_point"] = kernel_ds_per_point(net, args, cot, bwd)
  out_f, g_f = aggregator_grads(net, static, args, cot, "f32", rays)
  _, g_b = aggregator_grads(net, static, args, cot, "bf16", rays)
  return out_k, out_f, g_k, g_f, g_b


def grad_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                twin: Dict[str, torch.Tensor]
                ) -> Dict[str, Tuple[float, float, float]]:
  """{name: (kernel ratio, bf16-twin ratio, bar)} for every f32 gradient.

  The ratio's scale is ``max|g_f32|``; for the summed ``s``, when the f32
  per-point terms are given, it is the sum of their magnitudes."""
  out = {}
  for name, w in want.items():
    if name not in got:
      raise AssertionError(f"kernel path gave no gradient for {name}")
    if name == "s" and "s.per_point" in want:
      scale = float(want["s.per_point"].abs().sum())
    else:
      scale = float(w.abs().max())
    if scale == 0.0:
      ek = float(got[name].abs().max() > 0)
      eb = 0.0
    else:
      ek = float((got[name].float() - w).abs().max()) / scale
      eb = float((twin[name].float() - w).abs().max()) / scale
    out[name] = (ek, eb, 2.0 * eb + 0.02)
  return out


def check_grad_errors(errors: Dict[str, Tuple[float, float, float]],
                      what: str) -> float:
  """Raise if any ratio exceeds its bar; return the worst kernel ratio."""
  bad = {n: e for n, e in errors.items() if not e[0] <= e[2]}
  if bad:
    raise AssertionError(f"{what}: gradients beyond the bar (kernel, twin, "
                         f"bar): {bad}")
  return max(e[0] for e in errors.values())


def error_coherence(got: torch.Tensor, want: torch.Tensor) -> float:
  """``|sum(got - want)| / sum|got - want|``: 1 when every per-point error
  has one sign (they add up in a sum), about ``1/sqrt(n)`` when the signs
  are random (they cancel)."""
  e = (got.float() - want.float()).reshape(-1)
  total = float(e.abs().sum())
  return float(e.sum().abs()) / total if total > 0 else 0.0


@contextlib.contextmanager
def sliced_twin(net: nn.Module, rays: int = TWIN_RAYS) -> Iterator[None]:
  """Within the block, ``net``'s forward runs ``rays`` rays at a time under
  activation checkpointing: the same function and gradients, with the
  memory of one slice of activations (every input is [R, ...])."""
  plain = net.forward

  def forward(*args):
    parts = [checkpoint(plain, *(a[i:i + rays] for a in args),
                        use_reentrant=False)
             for i in range(0, args[0].shape[0], rays)]
    return torch.cat(parts)

  net.forward = forward
  try:
    yield
  finally:
    del net.forward


ATTN_FIELDS = ("o", "dq", "dk", "dv", "m", "l")


def _bf16(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.bfloat16).float()


def attention_inputs(dev, r: int, s: int, seed: int):
  """q, k, v, d_o [R,S,128] bf16 and per-query valid-view counts [R,S]
  from a seed: ray 0 with no valid view, ray 1 with one at every sample,
  the others 0-4 (a quarter or so attend uniformly)."""
  g = torch.Generator().manual_seed(seed)
  qkvo = [torch.randn(r, s, 128, generator=g).to(torch.bfloat16)
          for _ in range(4)]
  nvalid = torch.randint(0, 5, (r, s), generator=g).float()
  nvalid[0] = 0.0
  nvalid[1] = 1.0
  return [t.to(dev) for t in qkvo + [nvalid]]


def ray_attention_plain(q, k, v, d_o, nvalid) -> Dict[str, torch.Tensor]:
  """The ray transformer's attention, forward and backward, in f32 with
  bf16 rounding where csrc/attn_mma.cuh rounds (the JAX bodies' points):
  the exponentials before the product with v, the probabilities and the
  logit cotangents before theirs, and every output.  q, k, v, d_o
  [R,S,128] bf16 (4 heads of 32); nvalid [R,S], each query's count of
  valid views: a query with at most one attends uniformly and drops its
  logit cotangents.  Returns o, dq, dk, dv [R,S,128] bf16 and each
  query's max logit m and sum of exponentials l [R,4,S]."""
  r, s, _ = q.shape
  heads = [t.float().reshape(r, s, 4, 32).transpose(1, 2)
           for t in (q, k, v, d_o)]
  qh, kh, vh, doh = heads
  scale = 0.17677669529663687
  uni = (nvalid <= 1.0)[:, None, :, None]
  x = torch.where(uni, 0.0, (qh @ kh.transpose(-1, -2)) * scale)
  m = x.amax(-1, keepdim=True)
  e = torch.exp(x - m)
  l = e.sum(-1, keepdim=True)
  o = (_bf16(e) @ vh) * (1.0 / l)
  p = torch.where(uni, 0.0, e * (1.0 / l))
  dp = doh @ vh.transpose(-1, -2)
  ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
  dq = _bf16(ds) @ kh
  dk = _bf16(ds).transpose(-1, -2) @ qh
  dv = _bf16(torch.where(uni, 1.0 / s, p)).transpose(-1, -2) @ doh
  out = {n: t.transpose(1, 2).reshape(r, s, 128).to(torch.bfloat16)
         for n, t in zip(ATTN_FIELDS, (o, dq, dk, dv))}
  out.update(m=m[..., 0], l=l[..., 0])
  return out


def ray_attention(q, k, v, d_o, nvalid) -> Dict[str, torch.Tensor]:
  """K4a's attention functions (csrc/attn_mma.cuh, launched alone from
  the K4a library) on CUDA tensors, as :func:`ray_attention_plain` returns
  them; on the CPU the plain version."""
  if q.device.type != "cuda":
    return ray_attention_plain(q, k, v, d_o, nvalid)
  r, s, _ = q.shape
  ins = [t.to(torch.bfloat16).contiguous() for t in (q, k, v, d_o)]
  nv = nvalid.float().contiguous()
  outs = [torch.empty_like(ins[0]) for _ in range(4)]
  stats = torch.empty((r, 12, agg._MAX_SAMPLES), dtype=torch.float32,
                      device=q.device)
  fn = agg._fn("dynamic_agg_bwd", "dyn_attention_check",
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
               + [ctypes.c_void_p])
  build.check(fn(*(t.data_ptr() for t in ins + [nv] + outs + [stats]),
                 r, s, agg._stream(q.device)), "K4a attention check")
  out = dict(zip(ATTN_FIELDS, outs))
  out.update(m=stats[:, 0:4, :s], l=stats[:, 4:8, :s])
  return out
