"""The mono slice: the port's render_rays_mono, losses and train step vs
the JAX package on the CPU.

Same numpy inputs and bridged weights (JAX ``MonoModel.init_params``, the
motion coefficients made nonzero) at a small size: 8 rays, 16 samples,
the mono view counts at num_source_views 3 and num_vv 3 (9 dynamic, 10
anchor, 6 static views), 32×48 sources, f32 everywhere (JAX: flax
aggregators and the exact gather).  The stochastic sample placement of
the train step takes JAX's uniforms on both sides.  Bars: the eval and
train renders within 2e-5; the 8 loss terms on one shared ``ret`` and
the bootstrap loss within 1e-6 relative; the f32 gradient per group of
``make_mono_loss_fn`` (full and bootstrap) within 1e-4 relative norm (the
bar of __graft_entry__.py:141); one Adam step within 1e-6.  The JAX
package's three-kernel static backward (``pallas_bwd="split3"``,
interpret mode) is held against the port's f32 twin at the shape and bar
of tests/test_pallas_agg.py:394-449.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.config import DynibarConfig
from dynibar_tpu.data import ray_batch as jray_batch
from dynibar_tpu.models.aggregators import DynamicAggregator as JDynamic
from dynibar_tpu.models.aggregators import StaticAggregator as JStatic
from dynibar_tpu.models.dynibar import MonoModel as JMonoModel
from dynibar_tpu.ops.pallas_agg import fused_dynamic_aggregator as jfused_dy
from dynibar_tpu.ops.pallas_agg import fused_static_aggregator as jfused_st
from dynibar_tpu.render import render_image as jrender_image
from dynibar_tpu.render.render_rays import render_rays_mono as jrender_mono
from dynibar_tpu.train import losses as jlosses
from dynibar_tpu.train import trainer as jtrainer
from dynibar_tpu_torch.config import (RenderSettings, TrainSettings,
                                      mono_render_settings)
from dynibar_tpu_torch.core import sampling
from dynibar_tpu_torch.data import ray_batch
from dynibar_tpu_torch.models.aggregators import (DynamicAggregator,
                                                  StaticAggregator)
from dynibar_tpu_torch.models.dynibar import MONO_KEYS, MonoModel
from dynibar_tpu_torch.ops import agg
from dynibar_tpu_torch.render import render_image
from dynibar_tpu_torch.render.render_rays import render_rays_mono
from dynibar_tpu_torch.train import losses, trainer
from dynibar_tpu_torch.utils import convert
from dynibar_tpu_torch.utils.device import to_device
from torch_port_threads import one_torch_thread  # noqa: F401

NUM_FRAMES, N_RAYS = 32, 8
KW = dict(n_samples=16, num_basis=4, anti_alias_pooling=True, mask_rgb=True)
CFG = mono_render_settings(num_source_views=3, num_vv=3, **KW)
JCFG = DynibarConfig(N_samples=16, N_importance=0, num_source_views=3,
                     num_vv=3, num_basis=4, compute_dtype="float32",
                     fused_aggregators=False, strip_sampling=False,
                     lrate_mlp=1e-3, lrate_feature=1e-3,
                     lrate_decay_steps=100).render_settings("mono")
TCFG = TrainSettings(lrate_mlp=1e-3, lrate_feature=1e-3,
                     lrate_decay_steps=100)
JCONFIG = DynibarConfig(N_samples=16, num_basis=4, lrate_mlp=1e-3,
                        lrate_feature=1e-3, lrate_decay_steps=100)
RNG = jax.random.PRNGKey(11)
CPU = torch.device("cpu")


def _torch_tree(x):
  if isinstance(x, dict):
    return {k: _torch_tree(v) for k, v in x.items()}
  return torch.from_numpy(np.array(x))


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
  jmodel = JMonoModel(cfg=JCFG, num_frames=NUM_FRAMES)
  params = _np(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
  # nonzero motion, so trajectories, the cycle and the regularizer move
  k = params["motion_mlp"]["coeff_kernel"]
  params["motion_mlp"]["coeff_kernel"] = (
      np.random.RandomState(5).randn(*k.shape) * 0.1).astype(np.float32)
  model = MonoModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  model.train_all()
  rb = jray_batch.synthetic_mono_batch(JCFG, n_rays=N_RAYS, h=32, w=48,
                                       num_frames=NUM_FRAMES)
  # anchor view 2 sits at offset 0: its cycle pair compares two roundings
  # of the same point, so its L1 term's gradient is the sign of rounding
  # noise in either framework.  Drop that view from the pairs.
  assert rb["anchor_offset_idx"][2] == 3 and rb["anchor_is_vv"][2] == 0
  rb["anchor_valid"][2] = 0.0
  # the train step's uniforms: JAX's stratified draw (render_rays.py:171)
  t_rand = np.array(jax.random.uniform(jax.random.split(RNG)[0],
                                       (N_RAYS, CFG.n_samples)))
  return jmodel, params, model, rb, t_rand


@pytest.fixture
def jax_uniforms(setup, monkeypatch):
  """The port's stochastic sample placement takes JAX's uniforms."""
  t_rand = torch.from_numpy(setup[4])
  monkeypatch.setattr(sampling, "_uniform", lambda *a: t_rand)


@pytest.fixture(scope="module")
def jax_renders(setup):
  """JAX eval render (det) and train render (JAX's stochastic draw)."""
  jmodel, params, _, rb, _ = setup

  def renders(p, jrb):
    fm = jtrainer.compute_featmaps(jmodel, p, jrb)
    ev = jrender_mono(jmodel, p, jrb, (fm[0], None, fm[2]), JCFG,
                      is_train=False, det=True)
    tr = jrender_mono(jmodel, p, jrb, fm, JCFG, is_train=True, det=False,
                      rng=RNG)
    return ev, tr

  jrb = {k: jnp.asarray(v) for k, v in rb.items()}
  return _np(jax.jit(renders)(jax.tree_util.tree_map(jnp.asarray, params),
                              jrb))


@pytest.fixture(scope="module")
def jax_grads(setup):
  """Loss, metrics and gradient of make_mono_loss_fn, full and bootstrap."""
  jmodel, params, _, rb, _ = setup
  weights = jlosses.schedule_weights(JCONFIG, 0)
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  jrb = {k: jnp.asarray(v) for k, v in rb.items()}
  out = {}
  for bootstrap in (False, True):
    loss_fn = jtrainer.make_mono_loss_fn(jmodel, JCFG, bootstrap=bootstrap)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp, jrb, weights, RNG)
    out[bootstrap] = (float(loss), _np(metrics), _np(grads))
  return out


@pytest.fixture(scope="module")
def port_eval(setup):
  _, _, model, rb, _ = setup
  trb = to_device(rb, CPU)
  with torch.no_grad():
    fm = model.encode_featmaps(trb["src_rgbs"], trb["static_src_rgbs"])
    return render_rays_mono(model, trb, fm, CFG, device="cpu",
                            is_train=False, det=True)


@pytest.fixture(scope="module")
def port_train(setup):
  _, _, model, rb, t_rand = setup
  trb = to_device(rb, CPU)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(sampling, "_uniform", lambda *a: torch.from_numpy(t_rand))
    with torch.no_grad():
      fm = model.encode_featmaps(trb["src_rgbs"], trb["static_src_rgbs"],
                                 trb["anchor_src_rgbs"])
      return render_rays_mono(model, trb, fm, CFG, device="cpu",
                              is_train=True, det=False,
                              generator=torch.Generator())


@pytest.mark.parametrize("name,key", [
    ("outputs_coarse_ref", "rgb"), ("outputs_coarse_ref", "weights"),
    ("outputs_coarse_ref", "depth"), ("outputs_coarse_ref", "render_flows"),
    ("outputs_coarse_ref", "exp_sf"), ("outputs_coarse_ref", "s_vals"),
    ("outputs_coarse_ref_dy", "rgb"), ("outputs_coarse_st", "rgb"),
    ("outputs_coarse_st", "weights")])
def test_eval_render(port_eval, jax_renders, name, key):
  np.testing.assert_allclose(port_eval[name][key].numpy(),
                             np.asarray(jax_renders[0][name][key], np.float32),
                             atol=2e-5)


def test_eval_render_has_no_anchor_branch(port_eval):
  assert set(port_eval) == {"outputs_coarse_ref", "outputs_coarse_ref_dy",
                            "outputs_coarse_st"}


@pytest.mark.parametrize("name,key", [
    ("outputs_coarse_ref", "rgb"), ("outputs_coarse_ref", "weights"),
    ("outputs_coarse_ref", "render_flows"), ("outputs_coarse_st", "rgb"),
    ("outputs_coarse_anchor", "rgb"), ("outputs_coarse_anchor", "weights"),
    ("outputs_coarse_anchor", "occ_weights"),
    ("outputs_coarse_anchor", "pts_traj_ref"),
    ("outputs_coarse_anchor", "pts_traj_anchor"),
    ("outputs_coarse_anchor", "sf_seq"),
    ("outputs_coarse_anchor_dy", "occ_weights"),
    ("outputs_coarse_anchor_dy", "occ_weight_map")])
def test_train_render(port_train, jax_renders, name, key):
  np.testing.assert_allclose(port_train[name][key].numpy(),
                             np.asarray(jax_renders[1][name][key], np.float32),
                             atol=2e-5)


def test_pair_valid(port_train, jax_renders):
  want = np.asarray(jax_renders[1]["outputs_coarse_anchor"]["pair_valid"])
  np.testing.assert_array_equal(
      port_train["outputs_coarse_anchor"]["pair_valid"].numpy(), want)


def test_loss_terms_on_a_shared_ret(setup, jax_renders):
  rb, ret = setup[3], jax_renders[1]
  weights = jlosses.schedule_weights(JCONFIG, 0)
  want = _np(jlosses.compute_mono_losses(
      ret, {k: jnp.asarray(v) for k, v in rb.items()}, weights))
  got = losses.compute_mono_losses(_torch_tree(ret), to_device(rb, CPU),
                                   losses.schedule_weights(TCFG, 0))
  assert set(got) == set(want) and len(want) == 9
  for key, value in want.items():
    np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-6,
                               atol=1e-9, err_msg=key)
  boot = losses.compute_bootstrap_loss(_torch_tree(ret), to_device(rb, CPU))
  np.testing.assert_allclose(
      float(boot), float(jlosses.compute_bootstrap_loss(
          ret, {k: jnp.asarray(v) for k, v in rb.items()})), rtol=1e-6)


@pytest.fixture(scope="module")
def port_grads(setup):
  _, _, model, rb, t_rand = setup
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(sampling, "_uniform", lambda *a: torch.from_numpy(t_rand))
    for bootstrap in (False, True):
      model.zero_grad(set_to_none=True)
      loss, metrics = trainer.mono_loss(
          model, to_device(rb, CPU), losses.schedule_weights(TCFG, 0), CFG,
          bootstrap=bootstrap, generator=torch.Generator())
      loss.backward()
      out[bootstrap] = (float(loss.detach()),
                        {k: float(v.detach()) for k, v in metrics.items()},
                        {k: p.grad.clone() for k, p in
                         model.named_parameters() if p.grad is not None})
  model.zero_grad(set_to_none=True)
  return out


@pytest.mark.parametrize("bootstrap", [False, True])
def test_loss_value(port_grads, jax_grads, bootstrap):
  got, want = port_grads[bootstrap], jax_grads[bootstrap]
  np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
  for key in ("psnr", "static_loss"):
    np.testing.assert_allclose(got[1][key], float(want[1][key]), rtol=1e-5,
                               err_msg=key)


@pytest.mark.parametrize("bootstrap", [False, True])
@pytest.mark.parametrize("group", MONO_KEYS)
def test_group_gradient(port_grads, jax_grads, group, bootstrap):
  grads, leaves = port_grads[bootstrap][2], convert._leaves(
      jax_grads[bootstrap][2])
  got, want = [], []
  for path, key, kind in convert.mono_entries(CFG):
    if path[0] != group:
      continue
    want.append(convert._to_torch(np.asarray(leaves[path]), kind).reshape(-1))
    # the bootstrap loss never reaches the dynamic model or the motion
    got.append(grads[key].numpy().reshape(-1) if key in grads
               else np.zeros_like(want[-1]))
  got, want = np.concatenate(got), np.concatenate(want)
  if bootstrap and group not in ("net_coarse_st", "feature_net_st"):
    assert np.linalg.norm(got) == 0 and np.linalg.norm(want) == 0
    return
  rel = np.linalg.norm(got - want) / np.linalg.norm(want)
  assert np.linalg.norm(want) > 0
  assert rel <= 1e-4, rel


def test_train_step_runs_and_counts(setup, jax_uniforms):
  """One mono_train_step on the CPU: finite metrics, every group updated,
  one update counted."""
  _, params, _, rb, _ = setup
  model = MonoModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  model.train_all()
  opt = trainer.make_mono_optimizer(model, TCFG)
  before = {k: v.clone() for k, v in model.state_dict().items()}
  loss, metrics, n = trainer.mono_train_step(
      model, opt, rb, losses.schedule_weights(TCFG, 0), CFG, TCFG,
      generator=torch.Generator())
  assert n == 1 and bool(torch.isfinite(loss))
  assert all(bool(torch.isfinite(v)) for v in metrics.values())
  changed = {k.split(".")[0] for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
  assert changed == set(MONO_KEYS)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_optimizer_step_matches_optax(setup, clip):
  """One update of the six groups from identical gradients; their global
  norm is far above 0.5, so the clip binds."""
  _, params, _, _, _ = setup
  model = MonoModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  model.train_all()
  tcfg = dataclasses.replace(TCFG, clip_grad_norm=clip)
  jconfig = dataclasses.replace(JCONFIG, clip_grad_norm=clip)
  opt = trainer.make_mono_optimizer(model, tcfg)
  assert [g["name"] for g in opt.param_groups] == list(MONO_KEYS)
  rng = np.random.RandomState(3)
  jgrads = jax.tree_util.tree_map(
      lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32), params)
  leaves = convert._leaves(jgrads)
  named = dict(model.named_parameters())
  entries = convert.mono_entries(CFG)
  for path, key, kind in entries:
    named[key].grad = torch.from_numpy(np.array(
        convert._to_torch(leaves[path], kind), order="C"))
  if clip:
    torch.nn.utils.clip_grad_norm_(list(named.values()), clip)
  trainer.set_lr(opt)
  opt.step()
  tx = jtrainer.make_mono_optimizer(jconfig)
  jp = jax.tree_util.tree_map(jnp.asarray, params)

  @jax.jit
  def update(g, p):
    updates, _ = tx.update(g, tx.init(p), p)
    return jax.tree_util.tree_map(lambda a, u: a + u, p, updates)

  want = convert._leaves(_np(update(
      jax.tree_util.tree_map(jnp.asarray, jgrads), jp)))
  sd = model.state_dict()
  for path, key, kind in entries:
    np.testing.assert_allclose(sd[key].numpy(),
                               convert._to_torch(want[path], kind),
                               atol=1e-6, err_msg=key)


def test_learning_rate_cap():
  """The decay cap comes from the first group, lrate_mlp · 0.5."""
  gamma = TCFG.lrate_decay_factor
  cap = trainer.lr_cap_exponent(TCFG.lrate_mlp * 0.5, gamma)
  assert cap == jtrainer._lr_cap_exponent(JCONFIG.lrate_mlp * 0.5, gamma)
  opt = trainer.make_mono_optimizer(
      MonoModel(CFG, NUM_FRAMES, device="cpu"), TCFG)
  assert {g["cap"] for g in opt.param_groups} == {cap}


def test_convert_round_trip(setup):
  _, params, model, _, _ = setup
  back = convert.state_dict_to_jax_params(model.state_dict(),
                                          convert.mono_entries(CFG))
  assert set(back) == set(params)
  want, got = convert._leaves(params), convert._leaves(back)
  assert set(got) == set(want)
  for path in want:
    np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))
  with pytest.raises(KeyError):
    convert.jax_params_to_state_dict(dict(params, stray={"k": np.zeros(1)}),
                                     convert.mono_entries(CFG))


def test_mono_settings_match_the_jax_config():
  for name in ("n_samples", "n_importance", "num_views_dy",
               "num_views_anchor", "num_views_static", "num_vv",
               "num_basis", "fused_bwd_impl", "fused_st_bwd_impl"):
    assert getattr(CFG, name) == getattr(JCFG, name), name
  bench = mono_render_settings()            # bench.py:257-261's counts
  assert (bench.num_views_dy, bench.num_views_anchor,
          bench.num_views_static) == (9, 10, 14)


@pytest.mark.parametrize("identity", [False, True])
def test_mono_ray_batch(identity):
  """synthetic_mono_batch: every array of the JAX batch at the mono
  settings, with and without the identity anchor view."""
  kw = dict(n_rays=8, h=24, w=32, num_frames=NUM_FRAMES,
            include_identity_anchor=identity)
  want = jray_batch.synthetic_mono_batch(JCFG, **kw)
  got = ray_batch.synthetic_mono_batch(CFG, **kw)
  assert set(got) == set(want)
  for k in want:
    assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  assert int(got["anchor_valid"].sum()) == 6 + 3 + identity


@pytest.mark.parametrize("route", ["pallas_split", "pallas_split3"])
def test_routes_on_the_cpu_take_the_twin(route):
  model = MonoModel(dataclasses.replace(CFG, fused_st_bwd_impl=route),
                    NUM_FRAMES, device="cpu")
  g = torch.Generator().manual_seed(0)
  args = (torch.randn(2, 4, 3, generator=g), torch.randn(2, 6, generator=g),
          torch.randn(2, 4, 3, 6, generator=g),
          torch.rand(2, 4, 3, 35, generator=g),
          torch.randn(2, 4, 3, 4, generator=g), torch.ones(2, 4, 3, 1))
  net = model.net_coarse_st
  with torch.no_grad():
    want = net(*args)
    assert torch.equal(agg.fused_static_aggregator(net, *args, bwd=route),
                       want)
    assert torch.equal(model.apply_st(None, *args), want)


@pytest.mark.parametrize("field,value", [
    ("fused_st_bwd_impl", "flax"), ("fused_st_bwd_impl", "pallas"),
    ("fused_bwd_impl", "pallas_split3"), ("fused_bwd_impl", "flax")])
def test_unknown_routes_raise(field, value):
  with pytest.raises(NotImplementedError, match="planned"):
    RenderSettings(**{field: value})
  if field == "fused_st_bwd_impl":
    with pytest.raises(NotImplementedError):
      agg.fused_static_aggregator(StaticAggregator(8, 4), *([None] * 6),
                                  bwd=value)
  else:
    with pytest.raises(NotImplementedError):
      agg.fused_dynamic_aggregator(DynamicAggregator(8, 4), *([None] * 5),
                                   bwd=value)


@pytest.mark.parametrize("route", ["pallas_split", "pallas"])
def test_dynamic_routes_on_the_cpu_take_the_twin(route):
  """fused_bwd_impl "pallas" (K3p/K4s on the card) is a valid route; on
  the CPU both dynamic routes run the f32 twin, forward and gradient."""
  cfg = dataclasses.replace(CFG, fused_bwd_impl=route)
  model = MonoModel(cfg, NUM_FRAMES, device="cpu").train_all()
  g = torch.Generator().manual_seed(1)
  args = [torch.randn(2, 4, 3, generator=g),
          torch.rand(2, 4, 3, 35, generator=g),
          torch.randn(2, 3, generator=g), torch.ones(2, 4, 3, 1),
          torch.full((2, 4, 1), 0.3)]
  net = model.net_coarse_dy
  want = net(*args)
  got = model.apply_dy(None, *args)
  assert torch.equal(got, want)
  gw = torch.autograd.grad(want.sum(), list(net.parameters()))
  gg = torch.autograd.grad(agg.fused_dynamic_aggregator(
      net, *args, bwd=route).sum(), list(net.parameters()))
  assert all(torch.equal(a, b) for a, b in zip(gg, gw))


def test_view_limit_is_fourteen():
  assert agg._MAX_VIEWS == 14
  agg._check_dims(64, 14, 35)
  with pytest.raises(ValueError, match="V<=14"):
    agg._check_dims(64, 15, 35)


def test_jax_pallas_backward_matches_the_port_twin():
  """dynibar_tpu's fused_dynamic_aggregator(pallas_bwd=True) (the primal
  kernel K3p and the single-kernel backward K4s) in interpret mode vs the
  port's f32 twin on converted weights: per leaf within twice the bf16
  flax module's error plus 0.02 (the bar of the split3 test below and of
  tests/test_pallas_agg.py:332-377, at its shape R,S,V,F = 6,16,5,32)."""
  r, s, v, f = 6, 16, 5, 32
  rng = np.random.RandomState(8)
  mask = (rng.rand(r, s, v, 1) > 0.2).astype(np.float32)
  ins = dict(pts=rng.randn(r, s, 3), rgb_feat=rng.rand(r, s, v, f + 3),
             ray_dir=rng.randn(r, 3), ray_diff=rng.randn(r, s, v, 4) * 0.1)
  ins = {k: a.astype(np.float32) for k, a in ins.items()}
  j = {k: jnp.asarray(a) for k, a in ins.items()}
  rest = (jnp.zeros((r, s, v, 1)), jnp.asarray(mask),
          jnp.full((r, s, 1), 0.37))
  jdy = JDynamic(in_feat_ch=f, n_samples=s, shift=5.0, compute_dtype=None)
  jdy16 = JDynamic(in_feat_ch=f, n_samples=s, shift=5.0,
                   compute_dtype=jnp.bfloat16)
  p = _np(jdy.init(jax.random.PRNGKey(4), j["pts"], j["rgb_feat"],
                   j["ray_dir"], j["ray_diff"], *rest)["params"])

  def loss(out):
    return jnp.mean(out[..., :3] ** 2) + jnp.mean(jnp.tanh(out[..., 3]))

  def jgrad(fn):
    return _np(jax.jit(jax.grad(lambda pp, rf, pts, rd: loss(fn(
        pp, pts, rf, rd, j["ray_diff"], *rest)), argnums=(0, 1, 2, 3)))(
            jax.tree_util.tree_map(jnp.asarray, p), j["rgb_feat"], j["pts"],
            j["ray_dir"]))

  g_pl = jgrad(lambda pp, *a: jfused_dy(pp, *a, shift=5.0, n_samples=s,
                                        interpret=True, pallas_bwd=True))
  g_16 = jgrad(lambda pp, *a: jdy16.apply({"params": pp}, *a))

  net = DynamicAggregator(f, s, shift=5.0)
  entries = convert.aggregator_entries(False, False)
  net.load_state_dict(convert.jax_params_to_state_dict(p, entries))
  t = {k: torch.from_numpy(ins[k]).requires_grad_(True)
       for k in ("rgb_feat", "pts", "ray_dir")}
  out = net(t["pts"], t["rgb_feat"], t["ray_dir"], torch.from_numpy(mask),
            torch.full((r, s, 1), 0.37))
  (torch.mean(out[..., :3] ** 2) + torch.mean(torch.tanh(out[..., 3]))
   ).backward()
  named = dict(net.named_parameters())
  pairs = []                                 # (kernel, bf16, port f32)
  for path, key, kind in entries:
    pairs.append((convert._to_torch(convert._leaves(g_pl[0])[path], kind),
                  convert._to_torch(convert._leaves(g_16[0])[path], kind),
                  named[key].grad.numpy()))
  for i, name in enumerate(("rgb_feat", "pts", "ray_dir")):
    pairs.append((g_pl[i + 1], g_16[i + 1], t[name].grad.numpy()))
  for a, b16, want in pairs:
    assert np.isfinite(a).all()
    scale = np.abs(want).max() + 1e-6
    err = np.abs(a - want).max() / scale
    err16 = np.abs(b16 - want).max() / scale
    assert err <= 2.0 * err16 + 0.02, (want.shape, err, err16)


def _small_camera(camera, h, w):
  """The batch camera at h×w pixels: the intrinsics scaled to match."""
  cam = np.array(camera, np.float32)
  scale = h / cam[0]
  k = cam[2:18].reshape(4, 4)
  k[:2, :3] *= scale
  cam[0], cam[1], cam[2:18] = h, w, k.reshape(-1)
  return cam


def test_render_image_mono_train_view(setup):
  """render_image_mono(train_view=True) vs the JAX one on converted weights,
  f32: an 8×12 view of the batch camera in two 48-ray chunks, every kept
  [H, W, .] field within 2e-5 (the render bar above), plus 2e-5 relative
  for the fields that scale with depth."""
  jmodel, params, model, rb, _ = setup
  cam = _small_camera(rb["camera"], 8, 12)
  jrb = {k: jnp.asarray(v) for k, v in rb.items()}
  jfull = jrender_image.full_image_ray_batch(jrb, jnp.asarray(cam))
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  want = jrender_image.render_image_mono(
      jmodel, jp, jfull, jtrainer.compute_featmaps(jmodel, jp, jfull), JCFG,
      chunk_size=48, height=8, width=12, train_view=True)
  full = render_image.full_image_ray_batch(rb, cam, device="cpu")
  with torch.no_grad():
    fm = model.encode_featmaps(full["src_rgbs"], full["static_src_rgbs"],
                               full["anchor_src_rgbs"])
  got = render_image.render_image_mono(model, full, fm, CFG, chunk_size=48,
                                       height=8, width=12, train_view=True,
                                       device="cpu")
  assert set(got) == set(want) == {"outputs_coarse_ref", "outputs_coarse_st",
                                   "outputs_coarse_anchor"}
  for name in want:
    assert set(got[name]) == set(want[name]), name
    for k, w in want[name].items():
      assert got[name][k].shape == w.shape, (name, k)
      np.testing.assert_allclose(got[name][k], np.asarray(w, np.float32),
                                 atol=2e-5, rtol=2e-5, err_msg=f"{name}.{k}")
  assert got["outputs_coarse_ref"]["render_flows"].shape == (8, 12, 6, 2)


def test_jax_split3_backward_matches_the_port_twin():
  """dynibar_tpu's fused_static_aggregator(pallas_bwd="split3") in
  interpret mode vs the port's f32 twin on converted weights: per leaf
  within twice the bf16 flax module's error plus 0.02 (the bar of
  tests/test_pallas_agg.py:394-449, at its shape R,S,V,F = 6,16,5,32)."""
  r, s, v, f = 6, 16, 5, 32
  rng = np.random.RandomState(9)
  mask = (rng.rand(r, s, v, 1) > 0.2).astype(np.float32)
  ins = dict(pts=rng.randn(r, s, 3), ref_pl=rng.randn(r, 6),
             src_pl=rng.randn(r, s, v, 6), rgb_feat=rng.rand(r, s, v, f + 3),
             ray_dir=rng.randn(r, 3), ray_diff=rng.randn(r, s, v, 4) * 0.1)
  ins = {k: a.astype(np.float32) for k, a in ins.items()}
  jst = JStatic(in_feat_ch=f, n_samples=s, compute_dtype=None)
  jst16 = JStatic(in_feat_ch=f, n_samples=s, compute_dtype=jnp.bfloat16)
  j = {k: jnp.asarray(a) for k, a in ins.items()}
  p = _np(jst.init(jax.random.PRNGKey(3), j["pts"], j["ref_pl"], j["src_pl"],
                   j["rgb_feat"], j["ray_dir"], j["ray_diff"],
                   jnp.asarray(mask))["params"])
  p["s"] = np.asarray(0.7, np.float32)  # a sharper anti-alias weighting

  def loss(out):
    return jnp.mean(out[..., :3] ** 2) + jnp.mean(jnp.tanh(out[..., 3]))

  def jgrad(fn):
    return _np(jax.jit(jax.grad(lambda pp, rf, rd, sp, rpl: loss(fn(
        pp, j["pts"], rpl, sp, rf, j["ray_dir"], rd, jnp.asarray(mask))),
        argnums=(0, 1, 2, 3, 4)))(jax.tree_util.tree_map(jnp.asarray, p),
                                  j["rgb_feat"], j["ray_diff"], j["src_pl"],
                                  j["ref_pl"]))

  g_pl = jgrad(lambda pp, *a: jfused_st(
      pp, *a, anti_alias_pooling=True, mask_rgb=True, interpret=True,
      pallas_bwd="split3"))
  g_16 = jgrad(lambda pp, *a: jst16.apply({"params": pp}, *a))

  net = StaticAggregator(f, s)
  entries = convert.aggregator_entries(True, True)
  net.load_state_dict(convert.jax_params_to_state_dict(p, entries))
  t = {k: torch.from_numpy(ins[k]).requires_grad_(k != "pts")
       for k in ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff")}
  out = net(t["pts"], t["ref_pl"], t["src_pl"], t["rgb_feat"],
            t["ray_diff"], torch.from_numpy(mask))
  (torch.mean(out[..., :3] ** 2) + torch.mean(torch.tanh(out[..., 3]))
   ).backward()
  named = dict(net.named_parameters())
  pairs = []                                 # (kernel, bf16, port f32)
  for path, key, kind in entries:
    pairs.append((convert._to_torch(convert._leaves(g_pl[0])[path], kind),
                  convert._to_torch(convert._leaves(g_16[0])[path], kind),
                  named[key].grad.numpy()))
  for i, name in enumerate(("rgb_feat", "ray_diff", "src_pl", "ref_pl")):
    pairs.append((g_pl[i + 1], g_16[i + 1], t[name].grad.numpy()))
  for a, b16, want in pairs:
    assert np.isfinite(a).all()
    scale = np.abs(want).max() + 1e-6
    err = np.abs(a - want).max() / scale
    err16 = np.abs(b16 - want).max() / scale
    assert err <= 2.0 * err16 + 0.02, (want.shape, err, err16)
