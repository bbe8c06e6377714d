"""The fine-stage FF train step: the port vs the JAX package on the CPU.

Same numpy inputs and bridged weights at the sizes of tests/test_ff_train.py
(6 + 6 samples, 7 dynamic, 6 anchor and 4 static views, 4 rays, 32×48
images), det=True on both sides, f32 everywhere (JAX: flax aggregators and
the exact gather).  Bars: loss terms on one shared ``ret`` within 1e-6
relative; the train-mode render within the fine-stage bar of
test_torch_port_render.py (5e-4); the f32 gradient of the whole loss per
trainable group within 1e-4 relative norm (the bar of
__graft_entry__.py:141); one Adam step within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.config import DynibarConfig
from dynibar_tpu.config import RenderSettings as JSettings
from dynibar_tpu.data import ray_batch as jray_batch
from dynibar_tpu.models.dynibar import FFModel as JFFModel
from dynibar_tpu.render.render_rays import render_rays_mv as jrender_rays_mv
from dynibar_tpu.train import losses as jlosses
from dynibar_tpu.train import trainer as jtrainer
from dynibar_tpu_torch.config import RenderSettings, TrainSettings
from dynibar_tpu_torch.data import ray_batch
from dynibar_tpu_torch.models.dynibar import (FF_COARSE_KEYS, FF_FINE_KEYS,
                                              FFModel)
from dynibar_tpu_torch.render.render_rays import render_rays_mv
from dynibar_tpu_torch.train import losses, trainer
from dynibar_tpu_torch.utils import convert
from dynibar_tpu_torch.utils.device import to_device
from torch_port_threads import one_torch_thread  # noqa: F401

NUM_FRAMES = 32
KW = dict(n_samples=6, n_importance=6, num_views_dy=7, num_views_anchor=6,
          num_views_static=4, num_basis=4, inv_uniform=True,
          anti_alias_pooling=True, mask_rgb=False)
JCFG = JSettings(num_vv=0, mono_time_diff=False, compute_dtype="float32",
                 fused_aggregators=False, strip_sampling=False, **KW)
CFG = RenderSettings(**KW)
TCFG = TrainSettings(lrate_mlp=1e-3, lrate_feature=1e-3,
                     lrate_decay_steps=100)
JCONFIG = DynibarConfig(N_samples=6, N_importance=6, num_basis=4,
                        lrate_mlp=1e-3, lrate_feature=1e-3,
                        lrate_decay_steps=100)


def _torch_tree(x):
  if isinstance(x, dict):
    return {k: _torch_tree(v) for k, v in x.items()}
  if x is None:
    return None
  return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
  jmodel = JFFModel(cfg=JCFG, num_frames=NUM_FRAMES)
  params = jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
  # nonzero motion, so trajectories, the cycle and the regularizer move
  rng = np.random.RandomState(5)
  for name in ("motion_mlp", "motion_mlp_fine"):
    k = params[name]["coeff_kernel"]
    params[name]["coeff_kernel"] = (rng.randn(*k.shape) * 0.1).astype(
        np.float32)
  model = FFModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  model.train_fine()
  rb = jray_batch.synthetic_ff_batch(JCFG, n_rays=4, h=32, w=48,
                                     num_frames=NUM_FRAMES, ref_idx=10)
  # anchor view 2 sits at offset 0: its cycle pair compares two roundings
  # of the same point, so its L1 term's gradient is the sign of rounding
  # noise in either framework.  Drop that view from the pairs.
  assert rb["anchor_offset_idx"][2] == 3
  rb["anchor_valid"][2] = 0.0
  return jmodel, params, model, rb


@pytest.fixture(scope="module")
def jax_step(setup):
  """The JAX f32 loss, its terms, the train render and the gradient."""
  jmodel, params, _, rb = setup
  weights = jlosses.schedule_weights(JCONFIG, 0)

  def loss_fn(p, jrb):
    coarse_fm, fine_fm = jtrainer.compute_ff_featmaps(jmodel, p, jrb)
    ret = jrender_rays_mv(jmodel, p, jrb, coarse_fm, fine_fm, JCFG,
                          det=True, is_train=True, needs_grad=True)
    metrics = jlosses.compute_ff_losses(ret, jrb, weights)
    return metrics["loss"], (metrics, ret)

  jp = jax.tree_util.tree_map(jnp.asarray, params)
  jrb = {k: jnp.asarray(v) for k, v in rb.items()}
  (_, (metrics, ret)), grads = jax.jit(
      jax.value_and_grad(loss_fn, has_aux=True))(jp, jrb)
  return (jax.tree_util.tree_map(np.asarray, metrics),
          jax.tree_util.tree_map(np.asarray, ret),
          jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def port_render(setup):
  _, _, model, rb = setup
  trb = to_device(rb, torch.device("cpu"))
  with torch.no_grad():
    c, f = model.encode_featmaps(trb["src_rgbs"], trb["static_src_rgbs"],
                                 trb["anchor_src_rgbs"])
    return render_rays_mv(model, trb, c, f, CFG, device="cpu",
                          is_train=True, det=True)


@pytest.mark.parametrize("anneal", [False, True])
def test_schedule_weights(anneal):
  jcfg = DynibarConfig(anneal_cycle=anneal)
  cfg = TrainSettings(anneal_cycle=anneal)
  for epoch in (0, 149, 150, 151, 300, 750, 900):
    want = jlosses.schedule_weights(jcfg, epoch)
    got = losses.schedule_weights(cfg, epoch)
    for field in ("w_disp", "w_flow", "w_cycle", "w_reg", "w_skew_entropy",
                  "w_distortion", "dynamic_rgb_decay",
                  "use_dynamic_mask_rgb", "suppress_dynamic"):
      assert np.float32(getattr(got, field)) == np.asarray(
          getattr(want, field)), (epoch, field)


def test_loss_terms_on_a_shared_ret(setup, jax_step):
  _, _, _, rb = setup
  want, ret, _ = jax_step
  got = losses.compute_ff_losses(
      _torch_tree(ret), to_device(rb, torch.device("cpu")),
      losses.schedule_weights(TCFG, 0))
  assert set(got) == set(want)
  for key, value in want.items():
    np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-6,
                               atol=1e-9, err_msg=key)


@pytest.mark.parametrize("name,key", [
    ("outputs_fine_ref", "rgb"), ("outputs_fine_ref", "weights"),
    ("outputs_fine_ref_dy", "rgb"), ("outputs_fine_anchor", "rgb"),
    ("outputs_fine_anchor", "weights"), ("outputs_fine_anchor", "occ_weights"),
    ("outputs_fine_anchor", "pts_traj_ref"),
    ("outputs_fine_anchor", "pts_traj_anchor"),
    ("outputs_fine_anchor", "sf_seq"),
    ("outputs_fine_anchor_dy", "occ_weights")])
def test_train_render(port_render, jax_step, name, key):
  _, ret, _ = jax_step
  np.testing.assert_allclose(port_render[name][key].numpy(),
                             np.asarray(ret[name][key], np.float32),
                             atol=5e-4)


def test_pair_valid(port_render, jax_step):
  _, ret, _ = jax_step
  want = np.asarray(ret["outputs_fine_anchor"]["pair_valid"])
  np.testing.assert_array_equal(
      port_render["outputs_fine_anchor"]["pair_valid"].numpy(), want)
  # anchor offsets [-3,-2,0,1,2,3] with delta=+1: o=+3 falls outside the
  # window, o=0 was dropped
  assert want.tolist() == [True, True, False, True, True, False]


@pytest.fixture(scope="module")
def port_grads(setup):
  _, _, model, rb = setup
  model.zero_grad(set_to_none=True)
  loss, _ = trainer.ff_loss(model, to_device(rb, torch.device("cpu")),
                            losses.schedule_weights(TCFG, 0), CFG, det=True)
  loss.backward()
  grads = {k: None if p.grad is None else p.grad.clone()
           for k, p in model.named_parameters()}
  model.zero_grad(set_to_none=True)
  return float(loss.detach()), grads


def test_loss_value(port_grads, jax_step):
  np.testing.assert_allclose(port_grads[0], float(jax_step[0]["loss"]),
                             rtol=1e-5)


@pytest.mark.parametrize("group", FF_FINE_KEYS)
def test_fine_group_gradient(port_grads, jax_step, group):
  _, jgrads = port_grads[1], jax_step[2]
  leaves = convert._leaves(jgrads)
  got, want = [], []
  for path, key, kind in convert.ff_entries(CFG):
    if path[0] != group:
      continue
    assert port_grads[1][key] is not None, key
    got.append(port_grads[1][key].numpy().reshape(-1))
    want.append(convert._to_torch(np.asarray(leaves[path]), kind).reshape(-1))
  got, want = np.concatenate(got), np.concatenate(want)
  rel = np.linalg.norm(got - want) / np.linalg.norm(want)
  assert np.linalg.norm(want) > 0
  assert rel <= 1e-4, rel


def test_pallas_route_takes_the_twin_on_the_cpu(setup, port_grads):
  """fused_bwd_impl="pallas" (K3p/K4s on the card) in the FF model's fine
  and anchor passes: on the CPU the same twins, the same loss and every
  gradient equal to the default route's."""
  _, _, model, rb = setup
  cfg = dataclasses.replace(CFG, fused_bwd_impl="pallas")
  model.cfg = cfg
  try:
    model.zero_grad(set_to_none=True)
    loss, _ = trainer.ff_loss(model, to_device(rb, torch.device("cpu")),
                              losses.schedule_weights(TCFG, 0), cfg,
                              det=True)
    loss.backward()
    assert float(loss.detach()) == port_grads[0]
    for k, p in model.named_parameters():
      want = port_grads[1][k]
      assert (p.grad is None) == (want is None), k
      if want is not None:
        assert torch.equal(p.grad, want), k
  finally:
    model.cfg = CFG
    model.zero_grad(set_to_none=True)


def test_coarse_groups_get_no_gradient(port_grads):
  for key, g in port_grads[1].items():
    if key.split(".")[0] in FF_COARSE_KEYS:
      assert g is None, key


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_optimizer_step_matches_optax(setup, clip):
  """One update from identical gradients; their global norm is far above
  0.5, so the clip binds."""
  _, params, _, _ = setup
  model = FFModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  model.train_fine()
  tcfg = dataclasses.replace(TCFG, clip_grad_norm=clip)
  jconfig = dataclasses.replace(JCONFIG, clip_grad_norm=clip)
  opt = trainer.make_ff_optimizer(model, tcfg)
  rng = np.random.RandomState(3)
  entries = convert.ff_entries(CFG)
  # the frozen coarse groups' gradients are zero, as in the JAX step
  jgrads = {k: jax.tree_util.tree_map(
      lambda a, k=k: np.asarray(rng.randn(*np.shape(a)) if k in FF_FINE_KEYS
                                else np.zeros(np.shape(a)), np.float32), v)
            for k, v in params.items()}
  leaves = convert._leaves(jgrads)
  named = dict(model.named_parameters())
  for path, key, kind in entries:
    if path[0] in FF_FINE_KEYS:
      named[key].grad = torch.from_numpy(np.array(
          convert._to_torch(leaves[path], kind), order="C"))
  before = {k: v.clone() for k, v in model.state_dict().items()}
  if clip:
    torch.nn.utils.clip_grad_norm_(list(named.values()), clip)
  trainer.set_lr(opt)
  opt.step()
  tx = jtrainer.make_ff_optimizer(jconfig)
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, jgrads),
                         tx.init(jp), jp)
  want = convert._leaves(jax.tree_util.tree_map(
      np.asarray, jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)))
  sd = model.state_dict()
  for path, key, kind in entries:
    if path[0] in FF_FINE_KEYS:
      np.testing.assert_allclose(sd[key].numpy(),
                                 convert._to_torch(want[path], kind),
                                 atol=1e-6, err_msg=key)
    else:
      assert torch.equal(sd[key], before[key]), key


def test_learning_rate_schedule():
  gamma, steps = TCFG.lrate_decay_factor, TCFG.lrate_decay_steps
  first = TCFG.lrate_mlp * TCFG.lr_multipler
  cap = trainer.lr_cap_exponent(first, gamma)
  assert cap == jtrainer._lr_cap_exponent(first, gamma)
  want = jtrainer.steplr_schedule(first, gamma, steps, cap)
  for step in (0, steps - 1, steps, 3 * steps + 7, (cap + 2) * steps):
    assert np.float32(trainer.steplr(first, gamma, steps, cap, step)) == \
        np.float32(want(step)), step


def test_ray_batch_at_train_settings():
  """synthetic_ff_batch takes num_views_anchor from the settings, as the
  JAX package's does."""
  want = jray_batch.synthetic_ff_batch(JCFG, n_rays=8, h=24, w=32,
                                       num_frames=NUM_FRAMES)
  got = ray_batch.synthetic_ff_batch(CFG, n_rays=8, h=24, w=32,
                                     num_frames=NUM_FRAMES)
  assert got["anchor_src_rgbs"].shape[0] == 6
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("static", [True, False])
def test_cuda_dispatch_never_returns_a_graphless_tensor(monkeypatch, static):
  """The CUDA branch of the aggregator wrappers: with grad enabled it goes
  through the autograd Function (K2r/K3r + backward kernels), under
  no_grad it launches the forward kernel alone.  The launches are stubbed:
  this host has no card."""
  from dynibar_tpu_torch.models.aggregators import (DynamicAggregator,
                                                    StaticAggregator)
  from dynibar_tpu_torch.ops import agg
  calls = []
  out = torch.zeros(2, 4, 4)
  fn = agg._StaticAggFn if static else agg._DynamicAggFn
  monkeypatch.setattr(fn, "apply",
                      lambda *a: calls.append("function") or out)
  monkeypatch.setattr(agg, "_static_launch" if static else "_dynamic_launch",
                      lambda *a: calls.append("forward kernel") or (out, {}))
  g = torch.Generator().manual_seed(0)
  if static:
    net = StaticAggregator(8, 4)
    args = (torch.randn(2, 4, 3, generator=g), torch.randn(2, 6, generator=g),
            torch.randn(2, 4, 3, 6, generator=g),
            torch.rand(2, 4, 3, 11, generator=g),
            torch.randn(2, 4, 3, 4, generator=g), torch.ones(2, 4, 3, 1))
    call = agg._static_cuda
  else:
    net = DynamicAggregator(8, 4)
    args = (torch.randn(2, 4, 3, generator=g),
            torch.rand(2, 4, 3, 11, generator=g),
            torch.randn(2, 3, generator=g), torch.ones(2, 4, 3, 1),
            torch.full((2, 4, 1), 0.3))
    call = agg._dynamic_cuda
  with torch.enable_grad():
    call(net, *args)
  with torch.no_grad():
    call(net, *args)
  assert calls == ["function", "forward kernel"]
