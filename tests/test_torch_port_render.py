"""The whole slice: the port's render_rays_mv / render_image_ff vs the JAX
package's f32 exact-gather path (compute_dtype float32, flax aggregators,
no strip sampler) on the same synthetic_ff_batch and bridged weights.

Tolerances: the coarse stage agrees to 1e-4 (f32 MLP stacks summed in
another order).  The fine stage's depths come from inverse-CDF importance
resampling of the coarse weights, which amplifies their ~1e-5 differences
by 1/pdf of the bin a sample lands in, so fine depths agree to 1e-4
relative and the fine outputs to 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.config import RenderSettings as JSettings
from dynibar_tpu.data import ray_batch as jray_batch
from dynibar_tpu.models.dynibar import FFModel as JFFModel
from dynibar_tpu.render import render_image as jrender_image
from dynibar_tpu.render.render_rays import render_rays_mv as jrender_rays_mv
from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.data import ray_batch
from dynibar_tpu_torch.models.dynibar import FFModel
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_ff)
from dynibar_tpu_torch.render.render_rays import render_rays_mv
from dynibar_tpu_torch.utils import convert

N_RAYS, H, W = 32, 32, 48
KW = dict(n_samples=8, n_importance=8, num_views_dy=7, num_views_static=4,
          num_basis=6, inv_uniform=True)


@pytest.fixture(scope="module")
def setup():
  jcfg = JSettings(num_views_anchor=0, num_vv=0, compute_dtype="float32",
                   fused_aggregators=False, strip_sampling=False, **KW)
  cfg = RenderSettings(**KW)
  jmodel = JFFModel(cfg=jcfg, num_frames=48)
  params = jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
  # nonzero motion coefficients, so the displaced points are exercised
  rng = np.random.RandomState(5)
  for name in ("motion_mlp", "motion_mlp_fine"):
    k = params[name]["coeff_kernel"]
    params[name]["coeff_kernel"] = (rng.randn(*k.shape) * 0.01).astype(
        np.float32)
  model = FFModel(cfg, 48, device="cpu")
  convert.load_jax_params(model, params)
  return jcfg, cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), model


def _jax_featmaps(jmodel, jp, rb):
  def one(which):
    return (jmodel.apply_feature(jp, which, rb["src_rgbs"])[0], None,
            jmodel.apply_feature(jp, which, rb["static_src_rgbs"])[1])
  return one("feature_net"), one("feature_net_fine")


def _port_featmaps(model, rb):
  with torch.no_grad():
    return model.encode_featmaps(torch.from_numpy(rb["src_rgbs"]),
                                 torch.from_numpy(rb["static_src_rgbs"]))


@pytest.fixture(scope="module")
def rendered(setup):
  jcfg, cfg, jmodel, jp, model = setup
  rb = jray_batch.synthetic_ff_batch(jcfg, n_rays=N_RAYS, h=H, w=W,
                                     num_frames=48)

  @jax.jit
  def run(jp, jrb):
    c, f = _jax_featmaps(jmodel, jp, jrb)
    return c, f, jrender_rays_mv(jmodel, jp, jrb, c, f, jcfg, det=True)

  jc, jf, want = run(jp, {k: jnp.asarray(v) for k, v in rb.items()})
  c, f = _port_featmaps(model, rb)
  got = render_rays_mv(model, rb, c, f, cfg, device="cpu")
  return got, want, (c, f), (jc, jf)


def _close(got, want, atol, rtol=0.0):
  np.testing.assert_allclose(got.detach().float().numpy(),
                             np.asarray(want, np.float32), atol=atol,
                             rtol=rtol)


def test_featmaps_match(rendered):
  _, _, (c, f), (jc, jf) = rendered
  for g, w in ((c[0], jc[0]), (c[2], jc[2]), (f[0], jf[0]), (f[2], jf[2])):
    _close(g, w, atol=1e-4)


@pytest.mark.parametrize("key", ["rgb", "depth", "weights"])
def test_coarse_stage(rendered, key):
  got, want, _, _ = rendered
  _close(got["outputs_coarse_ref"][key], want["outputs_coarse_ref"][key],
         atol=1e-4)


def test_importance_resampled_depths(rendered):
  got, want, _, _ = rendered
  _close(got["outputs_fine_ref"]["z_vals"], want["outputs_fine_ref"]["z_vals"],
         atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("key", ["rgb", "depth", "weights", "rgb_static",
                                 "rgb_dy", "s_vals", "exp_sf"])
def test_fine_stage(rendered, key):
  got, want, _, _ = rendered
  _close(got["outputs_fine_ref"][key], want["outputs_fine_ref"][key],
         atol=5e-4)


def test_masks_and_flows(rendered):
  got, want, _, _ = rendered
  for name in ("outputs_coarse_ref", "outputs_fine_ref"):
    np.testing.assert_array_equal(got[name]["mask"].numpy(),
                                  np.asarray(want[name]["mask"]))
  assert got["outputs_fine_ref"]["mask"].float().mean() > 0.5
  _close(got["outputs_fine_ref"]["render_flows"],
         want["outputs_fine_ref"]["render_flows"], atol=2e-2, rtol=1e-4)


def test_frame_render(setup):
  """render_image_ff at 16x24, chunk 128 (three chunks).

  Compared on all but the last row and column: the offset-0 source view is
  the target camera itself, so those pixels' rays project exactly onto its
  border (x = W-1, y = H-1), where the in-bounds test is a tie that f32
  rounding decides either way in either framework."""
  jcfg, cfg, jmodel, jp, model = setup
  rb = jray_batch.synthetic_ff_batch(jcfg, n_rays=4, h=16, w=24,
                                     num_frames=48)
  jrb = {k: jnp.asarray(v) for k, v in rb.items()}
  jc, jf = jax.jit(lambda p, b: _jax_featmaps(jmodel, p, b))(jp, jrb)
  want = jrender_image.render_image_ff(
      jmodel, jp, jrender_image.full_image_ray_batch(jrb, jrb["camera"]),
      jc, jf, jcfg, chunk_size=128, height=16, width=24)
  c, f = _port_featmaps(model, rb)
  frame_rb = full_image_ray_batch(rb, rb["camera"], device="cpu")
  got = render_image_ff(model, frame_rb, c, f, cfg, chunk_size=128,
                        height=16, width=24, device="cpu")
  for name in ("outputs_coarse_ref", "outputs_fine_ref"):
    assert got[name]["rgb"].shape == (16, 24, 3)
    for key in ("mask", "rgb", "depth"):
      assert np.isfinite(got[name][key]).all()
      np.testing.assert_allclose(got[name][key][:-1, :-1],
                                 np.asarray(want[name][key])[:-1, :-1],
                                 atol=5e-4)


def test_synthetic_batch_is_the_jax_batch(setup):
  jcfg, cfg, _, _, _ = setup
  want = jray_batch.synthetic_ff_batch(jcfg, n_rays=16, h=24, w=32,
                                       num_frames=48, scanline=True)
  got = ray_batch.synthetic_ff_batch(cfg, n_rays=16, h=24, w=32,
                                     num_frames=48, scanline=True)
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
