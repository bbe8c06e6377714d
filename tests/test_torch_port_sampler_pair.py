"""K1's fused entry ``ops/sample.sample_views_pair`` (a view set's RGB and
feature maps at the same normalized points, written as rgb_feat
[R,S,V,3+C], the aggregators' layout) on CPU tensors, where it is its
plain twin ``sample_views_pair_plain``, vs the single-map twin and the JAX
package.

f32 throughout.  The pair equals ``cat(sample_views_plain(rgb),
sample_views_plain(feat))`` permuted to [R,S,V,3+C] exactly (the same
F.grid_sample calls); the JAX package's exact gather
``bilinear_sample_views`` of each map, and its
``core/projection.compute_with_motions`` (whose gather the port's takes
through the fused entry), within 1e-5: f32 rounding of the same
interpolation in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.core import projection as jproj
from dynibar_tpu.ops.grid_sample import bilinear_sample_views
from dynibar_tpu_torch.core import cameras as cam
from dynibar_tpu_torch.core import projection as proj
from dynibar_tpu_torch.core import sampling
from dynibar_tpu_torch.data.ray_batch import synthetic_poses
from dynibar_tpu_torch.ops.sample import (sample_views, sample_views_pair,
                                          sample_views_pair_plain,
                                          sample_views_plain)
from torch_port_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
H, W = 24, 40
# far outside / beyond an edge / exact corners and edges / just inside /
# just outside
SPECIAL = np.array([[-1e6, 2.0], [1.4, 0.1], [-1.0, -1.0], [1.0, 1.0],
                    [1.0, -1.0], [-1.0, 0.3], [1.0 - 1e-3, 1.0 - 1e-3],
                    [-1.0 - 1e-3, 0.0]], np.float32)


def _jax_exact(maps, grid):
  v, r, s, _ = grid.shape
  out = bilinear_sample_views(jnp.asarray(maps),
                              jnp.asarray(grid.reshape(v, r * s, 2)),
                              image_grad=False)
  return np.asarray(out, np.float32).reshape(v, r, s, -1)


def _maps_and_grid(v, c, seed):
  rng = np.random.RandomState(seed)
  rgbs = rng.rand(v, H, W, 3).astype(np.float32)
  feats = rng.randn(v, H // 4, W // 4, c).astype(np.float32)
  grid = (rng.rand(v, 9, 8, 2) * 2.4 - 1.2).astype(np.float32)
  grid[:, 0] = SPECIAL
  return rgbs, feats, grid


@pytest.mark.parametrize("v", [1, 4, 7])
@pytest.mark.parametrize("c", [32, 8])
def test_pair_twin_is_both_gathers_in_the_aggregators_layout(v, c):
  rgbs, feats, grid = _maps_and_grid(v, c, seed=10 * v + c)
  t_rgbs, t_feats, t_grid = (torch.from_numpy(a) for a in (rgbs, feats,
                                                           grid))
  before = sample_views.launches
  got = sample_views_pair(t_rgbs, t_feats, t_grid)
  assert sample_views.launches == before         # no kernel launch on CPU
  assert got.shape == (9, 8, v, 3 + c) and got.is_contiguous()
  assert got.dtype == torch.float32
  want = torch.cat([sample_views_plain(t_rgbs, t_grid),
                    sample_views_plain(t_feats, t_grid)],
                   dim=-1).permute(1, 2, 0, 3)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  torch.testing.assert_close(sample_views_pair_plain(t_rgbs, t_feats, t_grid),
                             got, rtol=0, atol=0)
  jax_both = np.concatenate([_jax_exact(rgbs, grid), _jax_exact(feats, grid)],
                            -1).transpose(1, 2, 0, 3)
  np.testing.assert_allclose(got.numpy(), jax_both, atol=ATOL)
  # outside the image every channel is zero; an exact corner is the pixel
  np.testing.assert_array_equal(got[0, 0].numpy(), 0.0)
  np.testing.assert_allclose(got[0, 2, :, :3].numpy(), rgbs[:, 0, 0],
                             atol=1e-6)
  np.testing.assert_allclose(got[0, 3, :, 3:].numpy(), feats[:, -1, -1],
                             atol=1e-6)


def _cameras(n, seed):
  poses = synthetic_poses(n + 1, seed)
  k = cam.intrinsics_from_hwf(H, W, 0.9 * W)
  return np.stack([cam.make_camera(H, W, k, poses[i]) for i in range(n + 1)])


@pytest.mark.parametrize("v", [3, 7])
@pytest.mark.parametrize("c", [32, 8])
def test_compute_with_motions_through_the_pair_matches_jax(v, c):
  """The port's compute_with_motions with the kernel sampler takes the
  fused entry (here its twin): rgb_feat, ray_diff and the mask against the
  JAX package's, with samples inside, on the edge of and outside the
  images, and against the port's two-gather path exactly."""
  r, s = 16, 8
  rng = np.random.RandomState(v + c)
  cams = _cameras(v, seed=v)
  ray_o = (rng.randn(r, 3) * 0.1).astype(np.float32)
  ray_d = np.concatenate([rng.randn(r, 2) * 0.3, np.ones((r, 1))],
                         -1).astype(np.float32)
  pts, _, _ = sampling.sample_along_ray(
      torch.from_numpy(ray_o), torch.from_numpy(ray_d),
      torch.tensor([1.8, 30.0]), s, True, True)
  xyz = pts[None] + torch.from_numpy(
      rng.randn(v, r, s, 3).astype(np.float32) * 0.05)
  imgs = rng.rand(v, H, W, 3).astype(np.float32)
  feats = rng.randn(v, H // 4, W // 4, c).astype(np.float32)
  valid = np.ones(v, np.float32)
  valid[-1] = 0.0
  args = (pts, xyz, torch.from_numpy(cams[0]), torch.from_numpy(imgs),
          torch.from_numpy(cams[1:]), torch.from_numpy(feats),
          torch.from_numpy(valid))
  got = proj.compute_with_motions(*args, sample_views)
  assert got[0].is_contiguous()
  want = jproj.compute_with_motions(
      jnp.asarray(pts.numpy()), jnp.asarray(xyz.numpy()),
      jnp.asarray(cams[0]), jnp.asarray(imgs), jnp.asarray(cams[1:]),
      jnp.asarray(feats), jnp.asarray(valid))
  inside = float(want[2].mean())
  assert 0.2 < inside < 1.0              # samples inside and outside
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                               atol=ATOL)
  two = proj.compute_with_motions(*args, sample_views_plain)
  for g, w in zip(got, two):
    torch.testing.assert_close(g, w, rtol=0, atol=0)
