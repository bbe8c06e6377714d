"""The port's Static/DynamicAggregator (the plain f32 twins of K2/K3) vs
the flax modules, f32, on weights bridged through utils/convert.py.

The bar is the one tests/test_torch_parity.py holds the flax modules to
against torch replicas of the reference: rgb atol 2e-5, sigma atol 2e-4
(sigma is an unsquashed logit of a deeper stack).  Inputs include masked
views, points with exactly one valid view (attention query masked) and a
ray whose samples see no view at all (sigma -1e9, dynamic rgb 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.models.aggregators import (DynamicAggregator as JDynamic,
                                            StaticAggregator as JStatic)
from dynibar_tpu_torch.models.aggregators import (DynamicAggregator,
                                                  StaticAggregator)
from dynibar_tpu_torch.ops.agg import (fused_dynamic_aggregator,
                                       fused_static_aggregator)
from dynibar_tpu_torch.utils import convert
from dynibar_tpu_torch.utils import kernel_check as kc
from torch_port_threads import one_torch_thread  # noqa: F401

R, S, F = 8, 16, 32


def _inputs(v, seed):
  rng = np.random.RandomState(seed)
  mask = (rng.rand(R, S, v, 1) > 0.3).astype(np.float32)
  mask[0] = 0.0                          # a ray no view sees
  mask[1, :, 1:] = 0.0                   # one valid view: masked queries
  mask[1, :, 0] = 1.0
  rgb_feat = rng.rand(R, S, v, F + 3).astype(np.float32)
  rgb_feat[2, :5, 0, :3] = 0.0           # black source pixels (mask_rgb)
  return dict(
      pts=rng.randn(R, S, 3).astype(np.float32),
      ref_pl=rng.randn(R, 6).astype(np.float32),
      src_pl=rng.randn(R, S, v, 6).astype(np.float32),
      rgb_feat=rgb_feat,
      ray_dir=rng.randn(R, 3).astype(np.float32),
      ray_diff=(rng.randn(R, S, v, 4) * 0.3).astype(np.float32),
      mask=mask,
      time=np.full((R, S, 1), 0.37, np.float32))


def _t(d, *keys):
  return [torch.from_numpy(d[k]) for k in keys]


def _bridge(module, jparams, static, anti_alias):
  entries = convert.aggregator_entries(static, anti_alias)
  params = jax.tree_util.tree_map(np.asarray, jparams)
  module.load_state_dict(convert.jax_params_to_state_dict(params, entries),
                         strict=True)
  return module.eval()


def _check(got, want):
  want = np.asarray(want)
  np.testing.assert_allclose(got[..., :3], want[..., :3], atol=2e-5)
  np.testing.assert_allclose(got[..., 3], want[..., 3], atol=2e-4, rtol=1e-4)
  assert (got[0, :, 3] == -1e9).all()    # no valid view: sigma filled


@pytest.mark.parametrize("aa,mrgb", [(True, True), (False, False)])
def test_static_matches_flax(aa, mrgb):
  v = 4
  d = _inputs(v, seed=0)
  jmod = JStatic(in_feat_ch=F, n_samples=S, anti_alias_pooling=aa,
                 mask_rgb=mrgb)
  args = [jnp.asarray(d[k]) for k in ("pts", "ref_pl", "src_pl", "rgb_feat",
                                      "ray_dir", "ray_diff", "mask")]
  jparams = jax.jit(jmod.init)(jax.random.PRNGKey(1), *args)["params"]
  if aa:
    jparams = dict(jparams, s=jnp.float32(0.7))
  want = jax.jit(jmod.apply)({"params": jparams}, *args)
  net = _bridge(StaticAggregator(F, S, aa, mrgb), jparams, True, aa)
  with torch.no_grad():
    got = net(*_t(d, "pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff",
                  "mask")).numpy()
  _check(got, want)


@pytest.mark.parametrize("shift", [0.0, 5.0])
def test_dynamic_matches_flax(shift):
  v = 3
  d = _inputs(v, seed=1)
  jmod = JDynamic(in_feat_ch=F, n_samples=S, shift=shift)
  args = [jnp.asarray(d["pts"]), jnp.asarray(d["rgb_feat"]),
          jnp.asarray(d["ray_dir"]), jnp.asarray(d["ray_diff"]),
          jnp.zeros((R, S, v, 1)), jnp.asarray(d["mask"]),
          jnp.asarray(d["time"])]
  jparams = jax.jit(jmod.init)(jax.random.PRNGKey(2), *args)["params"]
  want = jax.jit(jmod.apply)({"params": jparams}, *args)
  net = _bridge(DynamicAggregator(F, S, shift), jparams, False, False)
  with torch.no_grad():
    got = net(*_t(d, "pts", "rgb_feat", "ray_dir", "mask", "time")).numpy()
  _check(got, want)
  np.testing.assert_array_equal(got[0, :, :3], 0.0)


def test_masked_view_content_is_ignored():
  """A view slot with mask 0 contributes nothing: corrupting its pixels
  and features leaves the static output unchanged (the ragged-view
  contract of the JAX package).  Every point keeps view 0 valid: with no
  valid view the reference blends uniformly over all views."""
  d = _inputs(4, seed=3)
  d["rgb_feat"][:, :, 0, :3] += 0.1      # no black pixel in view 0
  d["mask"][:, :, -1] = 0.0
  d["mask"][:, :, 0] = 1.0
  net = StaticAggregator(F, S).eval()
  keys = ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff", "mask")
  with torch.no_grad():
    base = net(*_t(d, *keys))
    d["rgb_feat"][:, :, -1] = 0.63
    d["src_pl"][:, :, -1] = 7.7
    moved = net(*_t(d, *keys))
  torch.testing.assert_close(moved, base, rtol=1e-5, atol=1e-5)


def test_wrappers_on_cpu_are_the_modules():
  d = _inputs(4, seed=4)
  st, dy = StaticAggregator(F, S).eval(), DynamicAggregator(F, S).eval()
  before = (fused_static_aggregator.launches,
            fused_dynamic_aggregator.launches)
  with torch.no_grad():
    st_args = _t(d, "pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff", "mask")
    dy_args = _t(d, "pts", "rgb_feat", "ray_dir", "mask", "time")
    torch.testing.assert_close(fused_static_aggregator(st, *st_args),
                               st(*st_args), rtol=0, atol=0)
    torch.testing.assert_close(fused_dynamic_aggregator(dy, *dy_args),
                               dy(*dy_args), rtol=0, atol=0)
  assert (fused_static_aggregator.launches,
          fused_dynamic_aggregator.launches) == before


@pytest.mark.parametrize("static", [True, False])
def test_twin_gradients_in_ray_slices(static):
  """The card checks run the f32 twin in ray slices (kernel_check): the
  outputs and gradients equal one pass over all rays, the per-point
  anti-alias gradients sum to s's, and a checkpointed sliced forward
  (sliced_twin) gives the gradients of the plain forward."""
  d = _inputs(4, seed=5)
  torch.manual_seed(6)
  net = StaticAggregator(F, S) if static else DynamicAggregator(F, S)
  args = _t(d, *(kc.STATIC_INPUTS if static else kc.DYNAMIC_INPUTS))
  cot = torch.from_numpy(np.random.RandomState(7).randn(R, S, 4)
                         .astype(np.float32))
  out1, g1 = kc.aggregator_grads(net, static, args, cot, "f32", rays=R)
  out3, g3 = kc.aggregator_grads(net, static, args, cot, "f32", rays=3)
  torch.testing.assert_close(out3, out1, rtol=0, atol=1e-5)
  assert set(g3) == set(g1)
  assert ("s.per_point" in g1) == static
  for name, g in g1.items():   # 1e-6 floor: the blend-logit bias is 0 in math
    torch.testing.assert_close(g3[name], g, rtol=1e-4,
                               atol=1e-4 * float(g.abs().max()) + 1e-6)
  if static:
    assert g1["s.per_point"].shape == (R, S)
    assert net.s.shape == ()              # the scalar is back in place
    torch.testing.assert_close(g1["s.per_point"].sum(), g1["s"])
  net.requires_grad_(True)
  out = net(*args)
  (out * cot).sum().backward()
  want = {n: p.grad.clone() for n, p in net.named_parameters()}
  net.zero_grad(set_to_none=True)
  with kc.sliced_twin(net, rays=3):
    (net(*args) * cot).sum().backward()
  assert "forward" not in net.__dict__
  for n, p in net.named_parameters():
    torch.testing.assert_close(p.grad, want[n], rtol=1e-4,
                               atol=1e-4 * float(want[n].abs().max()) + 1e-6)
