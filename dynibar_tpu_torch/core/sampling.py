"""Sampling points along rays + importance (PDF) resampling.

Parity targets in the reference: ``sample_along_camera_ray``
(ibrnet/render_ray.py:67-131), ``sample_pdf`` (:19-64) and ``z_to_s``
(:399-404).  Stochastic draws come from an explicit ``torch.Generator`` or
are handed in (``t_rand`` / ``u``), so tests can feed both frameworks the
same uniforms.  Under a mesh the steps pass a :class:`RowShard`: each
rank draws the global ``[N_rand, ...]`` uniforms from the generator that
every rank seeds alike and keeps its rows, so the sharded step places
every sample where one card does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class RowShard:
  """A generator shared by the ranks of a mesh: rank ``rank`` of
  ``world`` keeps rows ``[rank·n, (rank+1)·n)`` of each global draw."""

  generator: torch.Generator
  rank: int
  world: int

  @property
  def device(self) -> torch.device:
    return self.generator.device


Generator = Union[torch.Generator, RowShard]


def z_to_s(z_vals: torch.Tensor, near, far) -> torch.Tensor:
  """Normalized inverse-depth distance (mip-NeRF 360)."""
  return ((1.0 / z_vals) - (1.0 / near)) / (1.0 / far - 1.0 / near)


def _uniform(shape, like: torch.Tensor,
             generator: Optional[Generator]) -> torch.Tensor:
  if generator is None:
    raise ValueError("stochastic sampling needs a generator or the uniforms")
  if isinstance(generator, RowShard):
    n = shape[0]
    full = torch.rand((n * generator.world,) + tuple(shape[1:]),
                      generator=generator.generator, dtype=like.dtype,
                      device=generator.device)
    return full[generator.rank * n:(generator.rank + 1) * n].to(like.device)
  return torch.rand(shape, generator=generator, dtype=like.dtype,
                    device=generator.device).to(like.device)


def sample_along_ray(
    ray_o: torch.Tensor,            # [R, 3]
    ray_d: torch.Tensor,            # [R, 3]
    depth_range: torch.Tensor,      # [2] (near, far)
    n_samples: int,
    inv_uniform: bool,
    det: bool,
    generator: Optional[Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Stratified samples.  Returns (pts [R,S,3], z_vals [R,S], s_vals [R,S])."""
  near, far = depth_range[0], depth_range[1]
  n_rays = ray_o.shape[0]
  steps = torch.arange(n_samples, dtype=ray_o.dtype, device=ray_o.device)
  if inv_uniform:
    start = 1.0 / near
    step = (1.0 / far - start) / (n_samples - 1)
    z_vals = (1.0 / (start + steps * step)).expand(n_rays, n_samples)
  else:
    step = (far - near) / (n_samples - 1)
    z_vals = (near + steps * step).expand(n_rays, n_samples)
  if not det:
    mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
    lower = torch.cat([z_vals[:, :1], mids], dim=-1)
    if t_rand is None:
      t_rand = _uniform(z_vals.shape, z_vals, generator)
    z_vals = lower + (upper - lower) * t_rand
  pts = z_vals[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
  return pts, z_vals, z_to_s(z_vals, near, far)


def sample_pdf(
    bins: torch.Tensor,       # [R, M+1] bin edges
    weights: torch.Tensor,    # [R, M]
    n_samples: int,
    det: bool,
    generator: Optional[Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Inverse-CDF importance sampling (NeRF's sample_pdf)."""
  weights = weights + 1e-5
  pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
  cdf = torch.cumsum(pdf, dim=-1)
  cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)   # [R, M+1]
  n_rays, m = weights.shape
  if u is None:
    if det:
      u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype,
                         device=bins.device).expand(n_rays, n_samples)
    else:
      u = _uniform((n_rays, n_samples), bins, generator)
  # reference counts i in [0, M): above += (u >= cdf[:, i]); cdf[:,0] == 0,
  # so above ∈ [1, M]: searchsorted(cdf[:, :M], u, side='right')
  above = torch.searchsorted(cdf[:, :m].contiguous(), u.contiguous(),
                             right=True)
  below = torch.clamp(above - 1, min=0)
  cdf_below = torch.gather(cdf, 1, below)
  cdf_above = torch.gather(cdf, 1, above)
  bins_below = torch.gather(bins, 1, below)
  bins_above = torch.gather(bins, 1, above)
  denom = cdf_above - cdf_below
  denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
  t = (u - cdf_below) / denom
  return bins_below + t * (bins_above - bins_below)


def importance_resample_z(
    z_vals: torch.Tensor,      # [R, S] coarse depths (sorted)
    weights: torch.Tensor,     # [R, S] coarse weights
    n_importance: int,
    inv_uniform: bool,
    det: bool,
    generator: Optional[Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Coarse-to-fine resampling (reference render_ray.py:789-825).

  Returns the merged, sorted depths [R, S + n_importance]."""
  weights = weights.detach()
  w = weights[:, 1:-1]
  if inv_uniform:
    inv_z = 1.0 / z_vals
    inv_mid = 0.5 * (inv_z[:, 1:] + inv_z[:, :-1])      # decreasing
    # the reference flips so bins are increasing before sampling
    inv_samples = sample_pdf(inv_mid.flip(-1), w.flip(-1), n_importance,
                             det=det, generator=generator, u=u)
    z_samples = 1.0 / inv_samples
  else:
    z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    z_samples = sample_pdf(z_mid, w, n_importance, det=det,
                           generator=generator, u=u)
  z_all = torch.cat([z_vals, z_samples], dim=-1)
  return torch.sort(z_all, dim=-1).values
