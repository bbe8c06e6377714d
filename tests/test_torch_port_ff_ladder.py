"""The FF eval ladder of the port (``scripts/port_eval_ff_synthetic.py``)
and the aggregators' bf16 twin it runs, against the JAX package on the
CPU.

  * ``utils/kernel_check.bf16_twin`` of the static aggregator (anti-alias
    pooling and the rgb mask on and off) and of the dynamic one (shift 0
    and 5) against the flax modules at ``compute_dtype=bfloat16`` on the
    same weights: atol 2e-2 (static) / 1e-2 (dynamic), rtol 2e-2, the
    bar the JAX package holds its bf16 kernels to against its f32 flax
    modules (tests/test_pallas_agg.py:80,90), and the -1e9 fills exact.
    The twin also differs from the f32 module by more than 1e-4 (it is
    not the f32 module under another name);
  * the script's ``exact_f32`` and ``exact_bf16`` rungs, from a port
    snapshot of the JAX weights (``utils/checkpoints.save_checkpoint``),
    against ``dynibar_tpu.eval.nvidia_eval.evaluate_scene`` configured
    as ``scripts/eval_ff_synthetic.py`` configures the matching mode, on
    one eval frame: every viewpoint's full, dynamic and static PSNR and
    SSIM.  exact_f32 within 1e-3 dB and 1e-5 (the f32 eval's bar,
    tests/test_torch_port_eval.py).  exact_bf16 within twice the largest
    difference between the JAX package's own exact_bf16 and exact_f32
    rungs, plus the f32 bar: two bf16 programs that round at different
    points (PyTorch's autocast and flax's dtype) each differ from f32 by
    about that much, so they differ from each other by at most about
    twice as much; the bf16 rungs must also differ from f32 (in both
    packages), or the bar would hold nothing;
  * ``production`` and ``fused_rgb`` raise NotImplementedError; without
    ``--device cpu`` and with no card the script raises as
    ``cli/eval_nvidia`` does.

The scene and the weights are ``tests/test_torch_port_eval.py``'s: 24
frames of 16x24 on poses off the writer's vertical line, the JAX weights
from a seed with the density heads' bias lowered, frame 18 (its module
docstring gives the reasons), here with the script's samples at 8 + 8
and its first eval frame at 18 (``SAMPLES``, ``FIRST_FRAME``).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.eval import nvidia_eval as jeval
from dynibar_tpu.models.aggregators import (DynamicAggregator as JDynamic,
                                            StaticAggregator as JStatic)
from dynibar_tpu_torch.eval import nvidia_eval
from dynibar_tpu_torch.models.aggregators import (DynamicAggregator,
                                                  StaticAggregator)
from dynibar_tpu_torch.models.dynibar import BF16_TWIN, FFModel
from dynibar_tpu_torch.data import synthetic_scene
from dynibar_tpu_torch.utils import checkpoints, convert
from dynibar_tpu_torch.utils import kernel_check as kc
from test_torch_port_aggregators import F, R, S, _bridge, _inputs, _t
from test_torch_port_eval import (EVAL_FRAME, EVAL_FRAMES, EVAL_H, EVAL_W,
                                  PSNR_TOL, SCENE, SSIM_TOL, Recorder,
                                  generic_poses, jax_ff_params)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the script's samples, coarse and fine each (its SAMPLES)
SAMPLES = 8
# the JAX script's settings per mode (scripts/eval_ff_synthetic.py),
# at one chunk for both
JAX_MODES = {"exact_f32": "float32", "exact_bf16": "bfloat16"}


def _script():
  spec = importlib.util.spec_from_file_location(
      "port_eval_ff_synthetic", ROOT / "scripts" / "port_eval_ff_synthetic.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _check_twin(got, want, f32, atol):
  want = np.asarray(want)
  np.testing.assert_allclose(got[..., :3], want[..., :3], atol=atol,
                             rtol=2e-2)
  keep = want[..., 3] > -1e8
  np.testing.assert_allclose(got[..., 3][keep], want[..., 3][keep],
                             atol=atol, rtol=2e-2)
  np.testing.assert_array_equal(got[..., 3][~keep], -1e9)
  assert (want[0, :, 3] == -1e9).all()
  assert np.abs(got - f32).max() > 1e-4      # not the f32 module


@pytest.mark.parametrize("aa,mrgb", [(True, True), (False, False)])
def test_static_bf16_twin_matches_flax_bf16(aa, mrgb):
  v = 4
  d = _inputs(v, seed=0)
  args = [jnp.asarray(d[k]) for k in ("pts", "ref_pl", "src_pl", "rgb_feat",
                                      "ray_dir", "ray_diff", "mask")]
  jmod = JStatic(in_feat_ch=F, n_samples=S, anti_alias_pooling=aa,
                 mask_rgb=mrgb)
  jparams = jax.jit(jmod.init)(jax.random.PRNGKey(1), *args)["params"]
  if aa:
    jparams = dict(jparams, s=jnp.float32(0.7))
  jbf16 = JStatic(in_feat_ch=F, n_samples=S, anti_alias_pooling=aa,
                  mask_rgb=mrgb, compute_dtype=jnp.bfloat16)
  want = jax.jit(jbf16.apply)({"params": jparams}, *args)
  net = _bridge(StaticAggregator(F, S, aa, mrgb), jparams, True, aa)
  ins = _t(d, "pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff", "mask")
  with torch.no_grad():
    got = kc.bf16_twin(net, True, ins).numpy()
    f32 = net(*ins).numpy()
  _check_twin(got, want, f32, atol=2e-2)


@pytest.mark.parametrize("shift", [0.0, 5.0])
def test_dynamic_bf16_twin_matches_flax_bf16(shift):
  v = 3
  d = _inputs(v, seed=1)
  args = [jnp.asarray(d["pts"]), jnp.asarray(d["rgb_feat"]),
          jnp.asarray(d["ray_dir"]), jnp.asarray(d["ray_diff"]),
          jnp.zeros((R, S, v, 1)), jnp.asarray(d["mask"]),
          jnp.asarray(d["time"])]
  jmod = JDynamic(in_feat_ch=F, n_samples=S, shift=shift)
  jparams = jax.jit(jmod.init)(jax.random.PRNGKey(2), *args)["params"]
  jbf16 = JDynamic(in_feat_ch=F, n_samples=S, shift=shift,
                   compute_dtype=jnp.bfloat16)
  want = jax.jit(jbf16.apply)({"params": jparams}, *args)
  net = _bridge(DynamicAggregator(F, S, shift), jparams, False, False)
  ins = _t(d, "pts", "rgb_feat", "ray_dir", "mask", "time")
  with torch.no_grad():
    got = kc.bf16_twin(net, False, ins).numpy()
    f32 = net(*ins).numpy()
  _check_twin(got, want, f32, atol=1e-2)
  np.testing.assert_array_equal(got[0, :, :3], 0.0)


def test_kernels_choice_is_checked():
  model = FFModel(nvidia_eval.DynibarConfig().render_settings("ff"), 24,
                  device="cpu")
  with pytest.raises(ValueError, match=BF16_TWIN):
    model.apply_dy("fine", *([None] * 5), kernels="bf16")


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
  """The scene, a port snapshot of the JAX weights, and the JAX model and
  params: (root, snapshot folder, jax model, jax params)."""
  root = tmp_path_factory.mktemp("ladder")
  synthetic_scene.write_synthetic_nvidia_scene(str(root), SCENE, EVAL_FRAMES,
                                               EVAL_H, EVAL_W)
  generic_poses(root)
  jcfg = _jax_config(root, "float32")
  jmodel, params = jax_ff_params(jcfg.render_settings("ff"))
  model = FFModel(nvidia_eval.DynibarConfig(
      N_samples=SAMPLES, N_importance=SAMPLES).render_settings("ff"),
      EVAL_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  ckpt = root / "ckpt"
  checkpoints.save_checkpoint(str(ckpt), 7, model.state_dict())
  return root, ckpt, jmodel, params


def _jax_config(root, dtype):
  """scripts/eval_ff_synthetic.py's config of the matching mode, at one
  chunk a view (the JAX render pads every chunk to chunk_size)."""
  return JConfig(folder_path=str(root), eval_scenes=[SCENE],
                 training_height=EVAL_H, N_samples=SAMPLES,
                 N_importance=SAMPLES, num_source_views=7, num_basis=6,
                 mask_static=False, chunk_size=EVAL_H * EVAL_W,
                 compute_dtype=dtype, fused_aggregators=False,
                 strip_sampling=False, fused_rgb_sampling=False)


def _argv(root, ckpt, mode):
  return ["--ckpt", str(ckpt), "--root", str(root), "--scene", SCENE,
          "--height", str(EVAL_H), "--frames", "1", "--mode", mode,
          "--device", "cpu"]


@pytest.fixture(scope="module")
def rungs(ladder):
  """{mode: (port Recorder, port result, JAX Recorder)} of both exact
  rungs on frame 18."""
  root, ckpt, jmodel, params = ladder
  out = {}
  for mode, dtype in JAX_MODES.items():
    with pytest.MonkeyPatch.context() as mp:
      want = Recorder(mp, jeval)
      jcfg = _jax_config(root, dtype)
      jeval.evaluate_scene(
          jcfg, type(jmodel)(cfg=jcfg.render_settings("ff"),
                             num_frames=EVAL_FRAMES),
          jax.tree_util.tree_map(jnp.asarray, params), SCENE,
          frame_range=range(EVAL_FRAME, EVAL_FRAME + 1), log_fn=want.log)
      got = Recorder(mp, nvidia_eval)
      script = _script()
      mp.setattr(script, "SAMPLES", SAMPLES)
      mp.setattr(script, "FIRST_FRAME", EVAL_FRAME)
      res = script.run(script.parse_args(_argv(root, ckpt, mode)))
    out[mode] = (got, res, want)
  return out


@pytest.mark.parametrize("mode", list(JAX_MODES))
def test_rung_renders_the_protocol(rungs, mode):
  got, res, want = rungs[mode]
  assert res["mode"] == mode and res["viewpoints"] == 11
  assert len(got.psnr) == len(want.psnr) == 3 * 11
  assert np.isfinite(got.psnr).all() and min(got.psnr) > 1.0
  for region in ("full", "dynamic", "static"):
    assert abs(res[region]["psnr"] - np.mean(got.psnr[
        ("full", "dynamic", "static").index(region)::3])) <= 1e-9
    assert np.isnan(res[region]["lpips"])
  assert res["card"] == "cpu" and res["s_per_viewpoint"] > 0


def test_exact_f32_rung_matches_jax(rungs):
  got, _, want = rungs["exact_f32"]
  np.testing.assert_allclose(got.psnr, want.psnr, atol=PSNR_TOL, rtol=0)
  np.testing.assert_allclose(got.ssim, want.ssim, atol=SSIM_TOL, rtol=0)


def test_exact_bf16_rung_matches_jax(rungs):
  got, _, want = rungs["exact_bf16"]
  got32, _, want32 = rungs["exact_f32"]
  for metric, tol in (("psnr", PSNR_TOL), ("ssim", SSIM_TOL)):
    g, w, g32, w32 = (np.asarray(getattr(r, metric))
                      for r in (got, want, got32, want32))
    own = np.abs(w - w32).max()            # what bf16 moves the JAX rung
    assert own > tol and np.abs(g - g32).max() > tol, metric
    err, bar = np.abs(g - w).max(), 2.0 * own + tol
    assert err <= bar, (metric, err, bar)


@pytest.mark.parametrize("mode", ["production", "fused_rgb"])
def test_tpu_modes_raise(mode):
  script = _script()
  with pytest.raises(NotImplementedError, match="TPU mode"):
    script.run(script.parse_args(["--mode", mode, "--device", "cpu"]))


def test_default_device_needs_cuda(ladder):
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA: the default device is valid here")
  root, ckpt, _, _ = ladder
  script = _script()
  argv = [a for a in _argv(root, ckpt, "fused_bf16") if a not in ("--device",
                                                                  "cpu")]
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    script.run(script.parse_args(argv))
