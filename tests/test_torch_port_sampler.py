"""K1's plain twin (ops/sample.sample_views on CPU tensors) vs the JAX
package's exact gather ``bilinear_sample_views`` and, where its window
covers a sample, the Pallas sampler in interpret mode.

Both compute grid_sample(align_corners=True, padding_mode='zeros'); f32
agrees to 1e-5.  bf16 maps: the twin interpolates in f32 and rounds once,
the JAX gather blends in bf16, so they agree to bf16 resolution (3e-2, the
bar tests/test_pallas_sample.py holds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.ops.grid_sample import bilinear_sample_views
from dynibar_tpu.ops.pallas_sample import pallas_bilinear_sample_views
from dynibar_tpu_torch.ops.sample import sample_views, sample_views_plain


def _jax_exact(maps, grid):
  v, r, s, _ = grid.shape
  out = bilinear_sample_views(jnp.asarray(maps),
                              jnp.asarray(grid.reshape(v, r * s, 2)),
                              image_grad=False)
  return np.asarray(out, np.float32).reshape(v, r, s, -1)


def _scanline_grids(v, r, s):
  """Adjacent rays with nearly identical epipolar segments (eval order)."""
  base = np.linspace(-0.4, 0.4, r).reshape(1, r, 1, 1)
  t = np.linspace(0.0, 1.0, s).reshape(1, 1, s, 1)
  g = np.concatenate([base * 0.3 - 0.3 + t * 0.55,
                      base * 0.05 + 0.05 + t * 0.12], -1)
  return np.broadcast_to(g, (v, r, s, 2)).astype(np.float32).copy()


@pytest.mark.parametrize("c", [3, 32])
def test_matches_exact_gather_f32(c):
  rng = np.random.RandomState(c)
  maps = rng.randn(3, 24, 40, c).astype(np.float32)
  grid = (rng.rand(3, 16, 8, 2) * 2.2 - 1.1).astype(np.float32)
  got = sample_views(torch.from_numpy(maps), torch.from_numpy(grid))
  assert got.shape == (3, 16, 8, c) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), _jax_exact(maps, grid), atol=1e-5)


def test_out_of_image_and_exact_borders():
  rng = np.random.RandomState(1)
  maps = rng.randn(1, 32, 48, 3).astype(np.float32)
  grid = _scanline_grids(1, 8, 8)
  # far outside / beyond an edge / exact corners and edges / just inside
  special = np.array([[-1e6, 2.0], [1.4, 0.1], [-1.0, -1.0], [1.0, 1.0],
                      [1.0, -1.0], [-1.0, 0.3], [1.0 - 1e-3, 1.0 - 1e-3],
                      [-1.0 - 1e-3, 0.0]], np.float32)
  grid[:, 0] = special
  got = sample_views(torch.from_numpy(maps), torch.from_numpy(grid)).numpy()
  np.testing.assert_allclose(got, _jax_exact(maps, grid), atol=1e-5)
  np.testing.assert_array_equal(got[0, 0, 0], 0.0)              # outside
  np.testing.assert_allclose(got[0, 0, 2], maps[0, 0, 0], atol=1e-6)
  np.testing.assert_allclose(got[0, 0, 3], maps[0, -1, -1], atol=1e-6)


def test_bfloat16_maps():
  rng = np.random.RandomState(2)
  maps = rng.randn(2, 24, 32, 6).astype(np.float32)
  grid = (rng.rand(2, 11, 8, 2) * 2.0 - 1.0).astype(np.float32)
  maps_bf = torch.from_numpy(maps).to(torch.bfloat16)
  got = sample_views(maps_bf, torch.from_numpy(grid))
  assert got.dtype == torch.bfloat16
  want = _jax_exact(jnp.asarray(maps).astype(jnp.bfloat16), grid)
  np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)
  # rounding once from f32: within one bf16 ulp of the f32 interpolation
  ref = sample_views(maps_bf.float(), torch.from_numpy(grid))
  err = (got.float() - ref).abs()
  assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-7).all())


def test_matches_pallas_window_where_covered():
  rng = np.random.RandomState(3)
  maps = rng.randn(2, 40, 64, 5).astype(np.float32)
  grid = _scanline_grids(2, 24, 16)
  vals, covered = pallas_bilinear_sample_views(
      jnp.asarray(maps), jnp.asarray(grid), group=8, interpret=True)
  cov = np.asarray(covered)[..., None]
  assert cov.mean() > 0.9
  got = sample_views(torch.from_numpy(maps), torch.from_numpy(grid)).numpy()
  np.testing.assert_allclose(got * cov, np.asarray(vals) * cov, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_twin():
  rng = np.random.RandomState(4)
  maps = torch.from_numpy(rng.randn(2, 9, 13, 4).astype(np.float32))
  grid = torch.from_numpy((rng.rand(2, 3, 5, 2) * 2 - 1).astype(np.float32))
  before = sample_views.launches
  torch.testing.assert_close(sample_views(maps, grid),
                             sample_views_plain(maps, grid), rtol=0, atol=0)
  assert sample_views.launches == before     # no kernel launch on CPU
