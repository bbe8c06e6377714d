"""The port's mesh (``parallel/mesh.py``) on the CPU, over gloo.

Two ranks are spawned once for the module (``tests/torch_mesh_worker.py``,
a ``file://`` store under the module's temporary directory) and run every
sharded path; the test holds what they return against the one-rank path
run here on the same inputs:

  * the mono full step, the bootstrap step, the FF fine step and the FF
    coarse step on one global batch of 16 rays (8 per rank): loss within
    1e-5 relative, ``grad_norm`` within 1e-4, each trained group's
    gradient within 1e-4 relative norm, the ranks' parameters identical
    after the step.  The one-rank steps are held to the JAX package by
    ``test_torch_port_mono.py``, ``_train.py`` and ``_ff_coarse.py``;
  * a negative control: the batch's halves have different mask sums, and
    the mean of the halves' own losses (what averaging per-rank losses
    computes) misses the 1e-4 gradient bar that the sharded loss meets;
  * ``render_image_ff`` and ``render_image_mono`` (with the training
    panels' fields) over 2 ranks against one within 1e-6, and the 2-rank
    FF frame against the JAX package's ``render_image_ff`` on a 2-device
    CPU mesh at 24x32, 8 + 8 samples (bridged weights; the bar of
    ``test_torch_port_render.py``'s frame, 5e-4);
  * ``cli/train``, ``cli/train_ff``, ``cli/eval_nvidia`` and
    ``cli/render_monocular`` under ``--mesh_shape 2``: one snapshot folder
    and one log, whose losses and PSNRs match the ``--mesh_shape 1``
    run's within 1e-4 (the two loader threads give both runs the same
    batches: the pipeline's deterministic order), and the same PNG frames,
    written by rank 0 alone;
  * a session with a follower answers two requests as a one-rank session,
    and a server on rank 0 over two scenes answers four concurrent
    requests, each with its own one-rank frame;
  * the errors: a mesh outside a launcher, ``mesh_shape`` other than the
    world, ``N_rand`` that does not split over the ranks;
  * ``shard_ray_batch``'s rows per key, ``RowShard``'s draws and the
    pipeline's order, without processes.
"""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.config import RenderSettings as JSettings
from dynibar_tpu.data import ray_batch as jray_batch
from dynibar_tpu.models.dynibar import FFModel as JFFModel
from dynibar_tpu.parallel.mesh import make_mesh
from dynibar_tpu.render import render_image as jrender_image
from dynibar_tpu_torch.cli import (eval_nvidia, render_monocular, train,
                                   train_ff)
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.core import sampling
from dynibar_tpu_torch.data import png, synthetic_scene
from dynibar_tpu_torch.data.factory import create_training_dataset
from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel
from dynibar_tpu_torch.parallel.mesh import (RAY_SHARDED_AXIS1_KEYS,
                                             RAY_SHARDED_KEYS, Mesh,
                                             shard_ray_batch, training_mesh)
from dynibar_tpu_torch.serve.session import RenderSession
from dynibar_tpu_torch.train import trainer
from dynibar_tpu_torch.utils import checkpoints as ckpt
from dynibar_tpu_torch.utils import convert
from dynibar_tpu_torch.utils.device import to_device

from tests import torch_mesh_worker as worker
from torch_port_threads import one_torch_thread  # noqa: F401

RANK_TIMEOUT_S = 300
CPU = torch.device("cpu")


def _jax_frame_setup():
  """JAX FF weights (motion made nonzero) and the port's copy of them."""
  jcfg = JSettings(compute_dtype="float32", fused_aggregators=False,
                   strip_sampling=False, num_vv=0,
                   **{k: getattr(worker.FRAME_CFG, k) for k in (
                       "n_samples", "n_importance", "num_views_dy",
                       "num_views_anchor", "num_views_static", "num_basis",
                       "inv_uniform")})
  jmodel = JFFModel(cfg=jcfg, num_frames=48)
  params = jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
  rng = np.random.RandomState(5)
  for name in ("motion_mlp", "motion_mlp_fine"):
    k = params[name]["coeff_kernel"]
    params[name]["coeff_kernel"] = (rng.randn(*k.shape) * 0.01).astype(
        np.float32)
  model = FFModel(worker.FRAME_CFG, 48, device="cpu")
  convert.load_jax_params(model, params)
  return jcfg, jmodel, params, model.state_dict()


def _jax_frame(jcfg, jmodel, params):
  """The JAX package's FF frame on a 2-device CPU mesh."""
  rb = jray_batch.synthetic_ff_batch(jcfg, n_rays=4, h=worker.FRAME_H,
                                     w=worker.FRAME_W, num_frames=48)
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  jrb = {k: jnp.asarray(v) for k, v in rb.items()}

  def featmaps(p, b):
    def one(which):
      return (jmodel.apply_feature(p, which, b["src_rgbs"])[0], None,
              jmodel.apply_feature(p, which, b["static_src_rgbs"])[1])
    return one("feature_net"), one("feature_net_fine")

  jc, jf = jax.jit(featmaps)(jp, jrb)
  return jrender_image.render_image_ff(
      jmodel, jp, jrender_image.full_image_ray_batch(jrb, jrb["camera"]),
      jc, jf, jcfg, chunk_size=worker.FRAME_CHUNK, height=worker.FRAME_H,
      width=worker.FRAME_W, mesh=make_mesh(jax.devices()[:2]))


def _spawn(workdir):
  ctx = multiprocessing.get_context("spawn")
  procs = [ctx.Process(target=worker.run, args=(r, workdir))
           for r in range(worker.WORLD)]
  for p in procs:
    p.start()
  return procs


def _join(procs):
  """Wait for the ranks; a rank that fails stops the others."""
  deadline = time.monotonic() + RANK_TIMEOUT_S
  while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
    if any(p.exitcode not in (None, 0) for p in procs):
      break
    time.sleep(0.2)
  for p in procs:
    if p.is_alive():
      p.kill()
    p.join()
  codes = [p.exitcode for p in procs]
  assert codes == [0] * len(procs), f"rank exit codes {codes}"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
  """The ranks' results and the one-rank references: the ranks start
  first, and this process computes the references while they run."""
  workdir = str(tmp_path_factory.mktemp("mesh"))
  root = os.path.join(workdir, "scenes")
  synthetic_scene.write_synthetic_scene(root, "s", num_frames=7,
                                        height=worker.SCENE_H,
                                        width=worker.SCENE_W)
  os.symlink(os.path.join(root, "s"), os.path.join(root, "t"))
  synthetic_scene.write_synthetic_nvidia_scene(
      root, "Balloon1", num_frames=12, height=worker.EVAL_H,
      width=worker.EVAL_W)
  jcfg, jmodel, params, ff_sd = _jax_frame_setup()
  torch.save(ff_sd, os.path.join(workdir, "ff.pt"))
  scfg = worker.session_config(root)
  mono_sd = MonoModel(scfg.render_settings("mono"), 7, device="cpu",
                      seed=1).state_dict()
  torch.save(mono_sd, os.path.join(workdir, "mono.pt"))
  snapshot = ckpt.save_checkpoint(os.path.join(workdir, "snap"), 1, mono_sd)
  procs = _spawn(workdir)
  threads = torch.get_num_threads()
  # the ranks' CPU kernels run on one thread each; so do the references,
  # whose rounding then matches theirs
  torch.set_num_threads(1)
  try:
    ref = {"steps": {k: worker.run_step(k) for k in worker.STEPS},
           "frame_ff": worker.frame_ff(ff_sd),
           "frame_mono": worker.frame_mono(),
           "jax_frame_ff": _jax_frame(jcfg, jmodel, params)}
    one_root = os.path.join(workdir, "train1")
    os.makedirs(one_root)
    os.symlink(os.path.join(root, "s"), os.path.join(one_root, "s"))
    ref["cli"] = train.main(worker.cli_args(one_root, mesh_shape=1))
    ref["eval"] = eval_nvidia.main(worker.eval_args(
        root, os.path.join(workdir, "eval1.json"), mesh_shape=1))
    ref["train_ff"] = train_ff.main(worker.ff_cli_args(
        root, os.path.join(workdir, "ff1"), mesh_shape=1))
    ref["render"] = render_monocular.main(worker.render_args(
        root, os.path.join(workdir, "render1"), snapshot, mesh_shape=1))
    session = RenderSession(scfg, state_dict=mono_sd, device="cpu")
    ref["served"] = [session.render(**r)
                     for r in worker.session_requests(session)]
    sessions = {name: RenderSession(
        dataclasses.replace(scfg, train_scenes=[name]), state_dict=mono_sd,
        device="cpu") for name in ("s", "t")}
    ref["concurrent"] = [
        sessions[r["scene"]].render(r["c2w"], r["frame_idx"],
                                    stride=r["stride"])["rgb"]
        for r in worker.concurrent_requests(session.data.c2w)]
  finally:
    torch.set_num_threads(threads)
    _join(procs)
  ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                      weights_only=False) for r in range(worker.WORLD)]
  return {"ranks": ranks, "ref": ref, "workdir": workdir}


def _rel(got, want):
  return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _groups(kind):
  model, opt, _, _, _ = worker.step_case(kind)
  names = {id(p): n for n, p in model.named_parameters()}
  return {g["name"]: [names[id(p)] for p in g["params"]]
          for g in opt.param_groups}


def test_ranks_join_over_gloo(env):
  assert [(r["rank"], r["world"], r["backend"]) for r in env["ranks"]] == [
      (0, 2, "gloo"), (1, 2, "gloo")]


@pytest.mark.parametrize("kind", worker.STEPS)
def test_sharded_step_loss(env, kind):
  want = env["ref"]["steps"][kind]
  for r in env["ranks"]:
    got = r["steps"][kind]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
      tol = 1e-4 if k == "grad_norm" else 1e-5
      np.testing.assert_allclose(got["metrics"][k], v, rtol=tol, atol=1e-7,
                                 err_msg=k)


@pytest.mark.parametrize("kind", worker.STEPS)
def test_sharded_step_group_gradients(env, kind):
  want = env["ref"]["steps"][kind]["grads"]
  got = env["ranks"][0]["steps"][kind]["grads"]
  assert set(got) == set(want)
  for group, names in _groups(kind).items():
    names = [n for n in names if n in want]
    if not names:                          # the bootstrap's dynamic groups
      continue
    g = torch.cat([got[n].reshape(-1) for n in names])
    w = torch.cat([want[n].reshape(-1) for n in names])
    assert torch.linalg.norm(w) > 0, group
    assert _rel(g, w) <= 1e-4, (group, _rel(g, w))


@pytest.mark.parametrize("kind", worker.STEPS)
def test_sharded_step_ranks_stay_identical(env, kind):
  a, b = (r["steps"][kind] for r in env["ranks"])
  for k in a["params"]:
    assert torch.equal(a["params"][k], b["params"][k]), k
  for k in a["grads"]:
    assert torch.equal(a["grads"][k], b["grads"][k]), k


def test_per_rank_mean_misses_the_bar():
  """Averaging the halves' own losses (DDP's mean of per-rank losses)
  gives another gradient when the halves' mask sums differ; the sharded
  loss (each half's numerators over the global denominators) sums to the
  one-card gradient."""
  model, _, rb, weights, cfg = worker.step_case("mono")
  rb = to_device(rb, CPU)
  half = Mesh(rank=0, world=2, device=CPU, backend="gloo")
  rows = [half.rows(worker.N_RAYS), Mesh(1, 2, CPU, "gloo").rows(
      worker.N_RAYS)]
  assert rb["motion_mask"][rows[0]].sum() != rb["motion_mask"][rows[1]].sum()

  def grads(loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()
                      if p.grad is not None])

  def loss_of(batch, mesh=None):
    return trainer.mono_loss(model, batch, weights, cfg, det=True,
                             mesh=mesh)[0]

  whole = grads(loss_of(rb))
  halves = [shard_ray_batch(Mesh(r, 2, CPU, "gloo"), rb) for r in (0, 1)]
  mean = grads(0.5 * (loss_of(halves[0]) + loss_of(halves[1])))
  assert _rel(mean, whole) > 1e-4

  class TwoHalves(Mesh):
    """Both ranks in one process: all_reduce records each half's local
    denominators until ``total`` is set, then returns their sum."""
    seen, total = [], None

    def all_reduce(self, t):
      if self.total is None:
        self.seen.append(t.clone())
        return t
      return t.copy_(self.total)

  mesh = TwoHalves(0, 2, CPU, "gloo")
  for h in halves:
    loss_of(h, mesh)
  mesh.total = mesh.seen[0] + mesh.seen[1]
  sharded = grads(loss_of(halves[0], mesh) + loss_of(halves[1], mesh))
  assert _rel(sharded, whole) <= 1e-5


@pytest.mark.parametrize("which", ["frame_ff", "frame_mono"])
def test_sharded_frame_matches_one_rank(env, which):
  want = env["ref"][which]
  got = env["ranks"][0][which]
  assert env["ranks"][1][which] is None
  assert set(got) == set(want)
  for name in want:
    assert set(got[name]) == set(want[name])
    for k, v in want[name].items():
      np.testing.assert_allclose(got[name][k], v, atol=1e-6,
                                 err_msg=f"{name}/{k}")


def test_sharded_ff_frame_matches_jax_mesh(env):
  """Compared inside the frame's one-pixel border: the target camera is
  also a source view, so a border pixel's ray projects onto that view's
  border, where the in-bounds test is an f32 tie either framework rounds
  either way (test_torch_port_render.py's frame leaves out the last row
  and column; at 24x32 the first row meets ties too)."""
  got, want = env["ranks"][0]["frame_ff"], env["ref"]["jax_frame_ff"]
  inner = (slice(1, -1), slice(1, -1))
  for name in ("outputs_coarse_ref", "outputs_fine_ref"):
    for key in ("mask", "rgb", "depth"):
      assert np.isfinite(got[name][key]).all()
      np.testing.assert_allclose(got[name][key][inner],
                                 np.asarray(want[name][key])[inner],
                                 atol=5e-4, err_msg=f"{name}/{key}")


def _records(out_folder, root):
  logs = os.path.join(root, "logs", os.path.basename(out_folder))
  with open(os.path.join(logs, "metrics.jsonl")) as fh:
    return [json.loads(line) for line in fh], logs


def test_train_cli_over_two_ranks(env):
  """One snapshot folder and one log, written by rank 0; the logged
  losses and PSNRs are the one-rank run's."""
  one, two = env["ref"]["cli"], env["ranks"][0]["cli"]
  assert env["ranks"][1]["cli"]["out_folder"] == two["out_folder"]
  assert sorted(os.listdir(two["out_folder"])) == sorted(
      os.listdir(one["out_folder"])) == ["args.json", "model_00000014.pt"]
  recs2, logs2 = _records(two["out_folder"],
                          os.path.join(env["workdir"], "train2"))
  recs1, logs1 = _records(one["out_folder"],
                          os.path.join(env["workdir"], "train1"))
  assert [r["step"] for r in recs2] == [r["step"] for r in recs1]
  assert sorted(os.listdir(os.path.join(logs2, "images"))) == sorted(
      os.listdir(os.path.join(logs1, "images")))
  assert recs1[0]["bootstrap/loss"] > 0 and recs1[2]["train/loss"] > 0
  for r1, r2 in zip(recs1, recs2):
    for k, v in r1.items():
      if k.split("/")[-1] in ("loss", "psnr", "static_loss", "rgb_loss"):
        np.testing.assert_allclose(r2[k], v, rtol=1e-4, err_msg=k)


def test_eval_cli_over_two_ranks(env):
  one, two = env["ref"]["eval"], env["ranks"][0]["eval"]
  assert env["ranks"][1]["eval"] == {}
  with open(os.path.join(env["workdir"], "eval2.json")) as fh:
    assert json.dumps(json.load(fh)) == json.dumps(two)   # LPIPS is NaN
  for region in ("full", "dynamic", "static"):
    for m in ("psnr", "ssim"):
      np.testing.assert_allclose(two["Balloon1"][region][m],
                                 one["Balloon1"][region][m], rtol=1e-6,
                                 err_msg=f"{region}/{m}")


def test_train_ff_cli_over_two_ranks(env):
  """One snapshot folder and one log, written by rank 0; the logged
  losses are the one-rank run's."""
  one, two = env["ref"]["train_ff"], env["ranks"][0]["train_ff"]
  assert sorted(os.listdir(two["out_folder"])) == sorted(
      os.listdir(one["out_folder"])) == ["args.json", "model_00000003.pt"]
  logs = [os.path.join(env["workdir"], d, "logs", "fine_ff", "metrics.jsonl")
          for d in ("ff1", "ff2")]
  recs1, recs2 = ([json.loads(line) for line in open(p)] for p in logs)
  assert [r["step"] for r in recs2] == [r["step"] for r in recs1]
  losses = [(r1["train_fine/loss"], r2["train_fine/loss"])
            for r1, r2 in zip(recs1, recs2) if "train_fine/loss" in r1]
  assert len(losses) == 3
  for a, b in losses:
    np.testing.assert_allclose(b, a, rtol=1e-4)


def test_render_cli_over_two_ranks(env):
  """Rank 0 writes the frames, equal to the one-rank run's; rank 1
  writes none."""
  one, two = env["ref"]["render"], env["ranks"][0]["render"]
  assert env["ranks"][1]["render"]["frames"] == []
  assert [os.path.basename(p) for p in two["frames"]] == [
      os.path.basename(p) for p in one["frames"]]
  assert len(one["frames"]) == 7
  for a, b in zip(one["frames"], two["frames"]):
    want = png.read(a)
    assert want.max() > 0
    np.testing.assert_array_equal(png.read(b), want)


def test_follower_session_answers_like_one_rank(env):
  served, want = env["ranks"][0]["served"], env["ref"]["served"]
  assert env["ranks"][1]["served"] == 2           # renders it followed
  for got, ref in zip(served, want):
    assert set(got) == set(ref) and ref["rgb"].max() > 0
    for k, v in ref.items():
      np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


def test_concurrent_requests_to_two_scenes(env):
  """Four requests to two scenes at once through make_server on rank 0,
  rank 1 following: every status 200, and each frame the one-rank render
  of its own request.  (Over gloo a follower's blocking collectives hold
  rank 0's next header back anyway; the mesh's lock, which NCCL's
  queued collectives need, is held by the test below.)"""
  got, want = env["ranks"][0]["concurrent"], env["ref"]["concurrent"]
  assert env["ranks"][1]["concurrent"] == len(want) == 4
  assert [status for status, _ in got] == [200] * 4
  for i, ((_, rgb), ref) in enumerate(zip(got, want)):
    assert ref.max() > 0
    np.testing.assert_allclose(rgb, ref, atol=1e-6, err_msg=f"request {i}")
  for i in range(4):                    # a swapped frame would show
    for j in range(i):
      assert want[i].shape != want[j].shape or not np.allclose(
          want[i], want[j], atol=1e-4), (i, j)


class _RecordingMesh(Mesh):
  """Rank 0 of two, in one process: logs which thread sends each header
  and each gather, slowly enough that unserialized renders would overlap,
  and gathers this rank's rows twice (the frame's shape, not its
  values)."""

  def __init__(self):
    super().__init__(rank=0, world=2, device=CPU, backend="gloo")
    self.log = []

  def broadcast_header(self, t):
    self.log.append(("header", threading.get_ident()))
    time.sleep(0.02)
    return t

  def gather_rows(self, t):
    self.log.append(("gather", threading.get_ident()))
    time.sleep(0.002)
    return torch.cat([t, t])


def test_mesh_renders_never_interleave(tmp_path):
  """Four renders on two scenes' sessions from four threads at once
  over one mesh: each render's header is followed by its own gathers
  alone, so followers, which replay the headers one at a time, meet
  rank 0's collectives in the same order."""
  synthetic_scene.write_synthetic_scene(str(tmp_path), "s", num_frames=7,
                                        height=worker.SCENE_H,
                                        width=worker.SCENE_W)
  os.symlink(tmp_path / "s", tmp_path / "t")
  cfg = worker.session_config(str(tmp_path))
  sd = MonoModel(cfg.render_settings("mono"), 7, device="cpu",
                 seed=1).state_dict()
  mesh = _RecordingMesh()
  sessions = {}
  for name in ("s", "t"):
    sessions[name] = RenderSession(
        dataclasses.replace(cfg, train_scenes=[name]), state_dict=sd,
        device="cpu")
    sessions[name].mesh = mesh
  reqs = worker.concurrent_requests(sessions["s"].data.c2w)
  start = threading.Barrier(len(reqs))

  def render(r):
    start.wait()
    return sessions[r["scene"]].render(r["c2w"], r["frame_idx"],
                                       stride=r["stride"])

  with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
    list(ex.map(render, reqs))
  assert [k for k, _ in mesh.log].count("header") == len(reqs)
  owner = None
  for kind, thread in mesh.log:
    if kind == "header":
      owner = thread
    assert thread == owner, mesh.log


def test_mesh_shape_must_equal_the_world(env):
  for r in env["ranks"]:
    assert "mesh_shape=3" in r["errors"]["mesh_shape"]


def test_n_rand_must_split_over_the_ranks(env):
  for r in env["ranks"]:
    assert "N_rand=7" in r["errors"]["n_rand"]
  with pytest.raises(ValueError, match="divisible by the mesh size 2"):
    shard_ray_batch(Mesh(0, 2, CPU, "gloo"), {"ray_o": torch.zeros(5, 3)})


@pytest.mark.parametrize("lines", [["mesh_shape = 2"], ["mesh_shape = 8"],
                                   ["distributed = True", "mesh_shape = 2"]])
def test_mesh_outside_a_launcher_raises(tmp_path, lines):
  """A config file asking for a mesh raises outside a launcher, naming
  torchrun; the JAX configs' ``distributed`` key parses and changes
  nothing."""
  path = tmp_path / "mesh.txt"
  path.write_text("\n".join(lines) + "\n")
  config = DynibarConfig.from_file(str(path))
  with pytest.raises(RuntimeError, match="torchrun"):
    training_mesh(config, "cpu")
  assert not hasattr(config, "distributed")
  assert training_mesh(DynibarConfig(mesh_shape="1"), "cpu") is None
  assert training_mesh(DynibarConfig(), "cpu") is None


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_ray_batch_rows(rank):
  rb = {k: torch.arange(8 * 3).reshape(8, 3) for k in RAY_SHARDED_KEYS}
  rb.update({k: torch.arange(6 * 8 * 2).reshape(6, 8, 2)
             for k in RAY_SHARDED_AXIS1_KEYS})
  rb["src_rgbs"] = torch.ones(4, 5, 5, 3)
  got = shard_ray_batch(Mesh(rank, 2, CPU, "gloo"), rb)
  rows = slice(4 * rank, 4 * rank + 4)
  for k in RAY_SHARDED_KEYS:
    assert torch.equal(got[k], rb[k][rows]), k
  for k in RAY_SHARDED_AXIS1_KEYS:
    assert torch.equal(got[k], rb[k][:, rows]), k
  assert got["src_rgbs"] is rb["src_rgbs"]


def test_row_shard_draws_the_global_rows():
  like = torch.zeros(())
  want = sampling._uniform((8, 5), like, torch.Generator().manual_seed(4))
  for r in range(4):
    got = sampling._uniform((2, 5), like, sampling.RowShard(
        torch.Generator().manual_seed(4), r, 4))
    assert torch.equal(got, want[2 * r:2 * r + 2])


def test_pipeline_order_is_deterministic():
  """Two pipelines of 3 threads and one seed yield the same 8 batches in
  the same order, whichever thread finishes first (a random sleep per
  draw)."""
  def sample(rng, _):
    time.sleep(np.random.uniform(0, 0.01))
    return {"x": rng.rand(3)}

  runs = []
  for _ in range(2):
    with PrefetchPipeline(sample, num_workers=3, seed=7) as pipe:
      runs.append([next(pipe)["x"] for _ in range(8)])
  for a, b in zip(*runs):
    np.testing.assert_array_equal(a, b)
  # batch k comes from worker k mod 3 at its step k // 3
  for k, x in enumerate(runs[0]):
    seed = (7 * 1_000_003 + (k % 3) * 7919 + k // 3) % (2 ** 31 - 1)
    np.testing.assert_array_equal(x, np.random.RandomState(seed).rand(3))


def test_curriculum_follows_the_batch_index(tmp_path):
  """Across two epoch boundaries (init_decay_epoch 1: the anchor pool
  widens every epoch), the training CLI's sampler under a pipeline of 3
  threads gives a consumer that sleeps between batches the batches of
  one that does not: batch k draws under epoch k // num_frames's
  curriculum, whenever its thread drew it."""
  synthetic_scene.write_synthetic_scene(str(tmp_path), "s", num_frames=7,
                                        height=worker.SCENE_H,
                                        width=worker.SCENE_W)
  config = DynibarConfig(folder_path=str(tmp_path), train_scenes=["s"],
                         training_height=worker.SCENE_H, N_rand=8,
                         num_source_views=2, num_vv=1, N_samples=10,
                         init_decay_epoch=1)
  data = create_training_dataset(config)
  sample = train.curriculum_sampler(data, config, start_epoch=0)
  n = 3 * data.num_frames
  runs = []
  for pause in (0.0, 0.02):
    with PrefetchPipeline(sample, num_workers=3, seed=5) as pipe:
      batches = []
      for _ in range(n):
        batches.append(next(pipe))
        time.sleep(pause)
    runs.append(batches)
  for k, (fast, slow) in enumerate(zip(*runs)):
    seed = (5 * 1_000_003 + (k % 3) * 7919 + k // 3) % (2 ** 31 - 1)
    want = sample(np.random.RandomState(seed), k)
    for key, v in want.items():
      np.testing.assert_array_equal(fast[key], v, err_msg=f"{k}/{key}")
      np.testing.assert_array_equal(slow[key], v, err_msg=f"{k}/{key}")
  offsets = [abs(int(b["anchor_frame_idx"]) - int(b["ref_frame_idx"]))
             for b in runs[0]]
  for k, off in enumerate(offsets):
    assert 1 <= off <= k // data.num_frames + 1, (k, offsets)
  assert max(offsets[2 * data.num_frames:]) == 3, offsets
