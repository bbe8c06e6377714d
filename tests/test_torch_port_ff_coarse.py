"""The FF coarse-stage train step: the port vs the JAX package on the CPU.

The fixtures of test_torch_port_train.py (6 samples, 7 dynamic, 6 anchor
and 4 static views, 4 rays, 32×48 images, bridged weights with nonzero
motion, anchor view 2 out of the cycle pairs), det=True on both sides,
f32 everywhere (JAX: flax aggregators and the exact gather).  Bars: the
train-mode coarse render (``render_rays_ff_coarse``) within 2e-5; the loss
terms on one shared ``ret`` within 1e-6 relative; the f32 gradient of the
whole loss per coarse group within 1e-4 relative norm (the bar of
__graft_entry__.py:141), none on the fine groups; one Adam step of
``make_ff_coarse_optimizer`` against optax within 1e-6.  One JAX
value_and_grad is compiled.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.render.render_rays import (
    render_rays_ff_coarse as jrender_rays_ff_coarse)
from dynibar_tpu.train import losses as jlosses
from dynibar_tpu.train import trainer as jtrainer
from dynibar_tpu_torch.models.dynibar import (FF_COARSE_KEYS, FF_FINE_KEYS,
                                              FFModel)
from dynibar_tpu_torch.render.render_rays import render_rays_ff_coarse
from dynibar_tpu_torch.train import losses, trainer
from dynibar_tpu_torch.utils import convert
from dynibar_tpu_torch.utils.device import to_device

from tests.test_torch_port_train import (CFG, JCFG, JCONFIG, NUM_FRAMES, TCFG,
                                         _torch_tree, setup)
from torch_port_threads import one_torch_thread  # noqa: F401

_ = setup                                    # the module-scoped fixture


@pytest.fixture(scope="module")
def coarse_model(setup):
  """The bridged weights in a coarse-mode model of this module's own."""
  _, params, _, _ = setup
  model = FFModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  return model.train_coarse()


@pytest.fixture(scope="module")
def jax_step(setup):
  """The JAX f32 loss, its terms, the train render and the gradient."""
  jmodel, params, _, rb = setup
  weights = jlosses.schedule_weights(JCONFIG, 0)

  def loss_fn(p, jrb):
    fm = jtrainer.compute_ff_coarse_featmaps(jmodel, p, jrb)
    ret = jrender_rays_ff_coarse(jmodel, p, jrb, fm, JCFG, det=True,
                                 is_train=True, needs_grad=True)
    metrics = jlosses.compute_mono_losses(ret, jrb, weights)
    mse = jnp.mean((ret["outputs_coarse_ref"]["rgb"] - jrb["rgb"]) ** 2)
    metrics["psnr"] = -10.0 * jnp.log(mse + 1e-8) / jnp.log(10.0)
    return metrics["loss"], (metrics, ret)

  jp = jax.tree_util.tree_map(jnp.asarray, params)
  jrb = {k: jnp.asarray(v) for k, v in rb.items()}
  (_, (metrics, ret)), grads = jax.jit(
      jax.value_and_grad(loss_fn, has_aux=True))(jp, jrb)
  return (jax.tree_util.tree_map(np.asarray, metrics),
          jax.tree_util.tree_map(np.asarray, ret),
          jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def port_render(setup, coarse_model):
  _, _, _, rb = setup
  trb = to_device(rb, torch.device("cpu"))
  with torch.no_grad():
    fm = coarse_model.encode_coarse_featmaps(
        trb["src_rgbs"], trb["static_src_rgbs"], trb["anchor_src_rgbs"])
    return render_rays_ff_coarse(coarse_model, trb, fm, CFG, device="cpu",
                                 is_train=True, det=True, needs_grad=False)


@pytest.mark.parametrize("name,key", [
    ("outputs_coarse_ref", "rgb"), ("outputs_coarse_ref", "weights"),
    ("outputs_coarse_ref", "depth"), ("outputs_coarse_ref", "render_flows"),
    ("outputs_coarse_ref", "exp_sf"), ("outputs_coarse_ref", "s_vals"),
    ("outputs_coarse_ref_dy", "rgb"), ("outputs_coarse_anchor", "rgb"),
    ("outputs_coarse_anchor", "weights"),
    ("outputs_coarse_anchor", "occ_weights"),
    ("outputs_coarse_anchor", "pts_traj_ref"),
    ("outputs_coarse_anchor", "pts_traj_anchor"),
    ("outputs_coarse_anchor", "sf_seq"),
    ("outputs_coarse_anchor_dy", "occ_weights")])
def test_train_render(port_render, jax_step, name, key):
  _, ret, _ = jax_step
  np.testing.assert_allclose(port_render[name][key].numpy(),
                             np.asarray(ret[name][key], np.float32),
                             atol=2e-5)


def test_render_keys(port_render, jax_step):
  """The mono key layout compute_mono_losses reads, and the pairs."""
  _, ret, _ = jax_step
  assert set(port_render) == set(ret)
  np.testing.assert_array_equal(
      port_render["outputs_coarse_anchor"]["pair_valid"].numpy(),
      np.asarray(ret["outputs_coarse_anchor"]["pair_valid"]))


@pytest.mark.parametrize("disp", [True, False])
def test_loss_terms_on_a_shared_ret(setup, jax_step, disp):
  """Without a disparity map (the Nvidia batches carry none) the term is
  zero and the rest as with one, as the JAX loss skips it
  (dynibar_tpu/train/losses.py:134-140)."""
  _, _, _, rb = setup
  want, ret, _ = jax_step
  trb = to_device(rb, torch.device("cpu"))
  if not disp:
    del trb["disp"]
    want = dict(want, loss=want["loss"] - want["disp_loss"],
                disp_loss=np.float32(0.0))
  got = losses.compute_mono_losses(_torch_tree(ret), trb,
                                   losses.schedule_weights(TCFG, 0))
  assert set(got) | {"psnr"} == set(want)
  for key, value in got.items():
    np.testing.assert_allclose(float(value), float(want[key]), rtol=1e-6,
                               atol=1e-9, err_msg=key)


@pytest.fixture(scope="module")
def port_grads(setup, coarse_model):
  _, _, _, rb = setup
  coarse_model.zero_grad(set_to_none=True)
  loss, metrics = trainer.ff_coarse_loss(
      coarse_model, to_device(rb, torch.device("cpu")),
      losses.schedule_weights(TCFG, 0), CFG, det=True)
  loss.backward()
  grads = {k: None if p.grad is None else p.grad.clone()
           for k, p in coarse_model.named_parameters()}
  coarse_model.zero_grad(set_to_none=True)
  return {k: float(v.detach()) for k, v in metrics.items()}, grads


def test_loss_and_metrics(port_grads, jax_step):
  want = jax_step[0]
  assert set(port_grads[0]) == set(want)
  for key, value in want.items():
    np.testing.assert_allclose(port_grads[0][key], float(value), rtol=1e-5,
                               atol=1e-8, err_msg=key)


@pytest.mark.parametrize("group", FF_COARSE_KEYS)
def test_coarse_group_gradient(port_grads, jax_step, group):
  leaves = convert._leaves(jax_step[2])
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


def test_fine_groups_get_no_gradient(port_grads, coarse_model):
  for key, g in port_grads[1].items():
    if key.split(".")[0] in FF_FINE_KEYS:
      assert g is None, key
  assert set(coarse_model.param_groups()) == set(FF_COARSE_KEYS)


def test_optimizer_needs_the_coarse_mode():
  model = FFModel(CFG, NUM_FRAMES, device="cpu").train_fine()
  with pytest.raises(ValueError, match="set its mode"):
    trainer.make_ff_coarse_optimizer(model, TCFG)
  with pytest.raises(ValueError, match="set its mode"):
    trainer.make_ff_optimizer(model.train_coarse(), TCFG)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_optimizer_step_matches_optax(setup, clip):
  """One update from identical gradients (the fine groups' zero, as in
  the JAX step); their global norm is far above 0.5, so the clip binds."""
  _, params, _, _ = setup
  model = FFModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  model.train_coarse()
  tcfg = dataclasses.replace(TCFG, clip_grad_norm=clip)
  jconfig = dataclasses.replace(JCONFIG, clip_grad_norm=clip)
  opt = trainer.make_ff_coarse_optimizer(model, tcfg)
  assert [g["name"] for g in opt.param_groups] == list(FF_COARSE_KEYS)
  rng = np.random.RandomState(4)
  entries = convert.ff_entries(CFG)
  jgrads = {k: jax.tree_util.tree_map(
      lambda a, k=k: np.asarray(rng.randn(*np.shape(a)) if k in
                                FF_COARSE_KEYS else np.zeros(np.shape(a)),
                                np.float32), v)
            for k, v in params.items()}
  leaves = convert._leaves(jgrads)
  named = dict(model.named_parameters())
  for path, key, kind in entries:
    if path[0] in FF_COARSE_KEYS:
      named[key].grad = torch.from_numpy(np.array(
          convert._to_torch(leaves[path], kind), order="C"))
  before = {k: v.clone() for k, v in model.state_dict().items()}
  if clip:
    torch.nn.utils.clip_grad_norm_(list(named.values()), clip)
  trainer.set_lr(opt)
  opt.step()
  tx = jtrainer.make_ff_coarse_optimizer(jconfig)
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  # one compiled update: optax's eager ops would each compile on their own
  updates, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(
      jax.tree_util.tree_map(jnp.asarray, jgrads), jp)
  want = convert._leaves(jax.tree_util.tree_map(
      np.asarray, jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)))
  sd = model.state_dict()
  for path, key, kind in entries:
    if path[0] in FF_COARSE_KEYS:
      np.testing.assert_allclose(sd[key].numpy(),
                                 convert._to_torch(want[path], kind),
                                 atol=1e-6, err_msg=key)
    else:
      assert torch.equal(sd[key], before[key]), key


def test_train_step_keeps_the_fine_groups(setup, coarse_model):
  """One ff_coarse_train_step (stochastic placement, clip on): the coarse
  groups move, the fine groups stay bit-identical, the metrics are
  finite."""
  _, params, _, rb = setup
  model = FFModel(CFG, NUM_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  model.train_coarse()
  tcfg = dataclasses.replace(TCFG, clip_grad_norm=1.0)
  opt = trainer.make_ff_coarse_optimizer(model, tcfg)
  before = {k: v.clone() for k, v in model.state_dict().items()}
  loss, metrics, steps = trainer.ff_coarse_train_step(
      model, opt, rb, losses.schedule_weights(tcfg, 0), CFG, tcfg,
      generator=torch.Generator().manual_seed(0))
  assert steps == 1 and torch.isfinite(loss)
  assert all(bool(torch.isfinite(v)) for v in metrics.values())
  moved = set()
  for k, v in model.state_dict().items():
    if k.split(".")[0] in FF_FINE_KEYS:
      assert torch.equal(v, before[k]), k
    elif not torch.equal(v, before[k]):
      moved.add(k.split(".")[0])
  assert moved == set(FF_COARSE_KEYS)
