"""One rank of tests/test_torch_port_mesh.py, and the inputs both share.

``run`` joins a gloo mesh on the CPU through a ``file://`` store, runs
every sharded path of the port on inputs built here from seeds (the test
builds the same ones for its one-rank references), and saves what it got
to ``<workdir>/rank<r>.pt``.  Nothing here imports JAX: the ranks are
fresh interpreters and need only torch.
"""

import concurrent.futures
import dataclasses
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import torch

from dynibar_tpu_torch.config import (DynibarConfig, RenderSettings,
                                      TrainSettings, mono_render_settings)
from dynibar_tpu_torch.data import ray_batch
from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_ff,
                                                   render_image_mono)
from dynibar_tpu_torch.train import losses, trainer

WORLD = 2
NUM_FRAMES, N_RAYS = 32, 16
MONO_CFG = mono_render_settings(num_source_views=3, num_vv=3, n_samples=16,
                                num_basis=4)
FF_CFG = RenderSettings(n_samples=6, n_importance=6, num_views_dy=7,
                        num_views_anchor=6, num_views_static=4, num_basis=4,
                        inv_uniform=True, mask_rgb=False)
# the frame renders: 24x32 (768 rays), 8 + 8 samples; chunk 128 splits
# each rank's half at the one-card chunks' edges
FRAME_CFG = RenderSettings(n_samples=8, n_importance=8, num_views_dy=7,
                           num_views_anchor=0, num_views_static=4,
                           num_basis=6, inv_uniform=True)
FRAME_H, FRAME_W, FRAME_CHUNK = 24, 32, 128
TCFG = TrainSettings(lrate_mlp=1e-3, lrate_feature=1e-3,
                     lrate_decay_steps=100)
STEP_SEED = 3
STEPS = ("mono", "bootstrap", "ff", "ff_coarse")
# the CLIs' scenes: 7 frames of 16x24 (training, serving; 10 samples: a
# mono ray's mask needs more than 8 valid ones), and a 12-frame Nvidia
# scene of 8x12 (eval: 11 static views, the eval's costliest stage)
SCENE_H, SCENE_W = 16, 24
EVAL_H, EVAL_W = 8, 12


def _motion(model, names) -> None:
  """Nonzero motion coefficients, so trajectories, the cycle and the
  regularizer move."""
  rng = np.random.RandomState(5)
  for name in names:
    lin = getattr(model, name).coeff_linear
    lin.weight.data.copy_(torch.from_numpy(
        (rng.randn(*lin.weight.shape) * 0.1).astype(np.float32)))


def _uneven_masks(rb) -> None:
  """The two halves' masks differ, so per-half ratio terms differ from the
  global ones: the negative control needs it."""
  n = rb["motion_mask"].shape[0]
  rb["motion_mask"][:n // 2] = 1.0
  rb["motion_mask"][n // 2:] = (np.arange(n - n // 2) % 4 == 0)
  rb["static_mask"][:n // 2] = 0.0


def step_case(kind: str):
  """(model, optimizer, global batch, loss weights, settings) of one
  train step, from seeds."""
  if kind in ("mono", "bootstrap"):
    model = MonoModel(MONO_CFG, NUM_FRAMES, device="cpu", seed=0)
    _motion(model, ["motion_mlp"])
    model.train_all()
    opt = trainer.make_mono_optimizer(model, TCFG)
    rb = ray_batch.synthetic_mono_batch(MONO_CFG, n_rays=N_RAYS, h=32, w=48,
                                        num_frames=NUM_FRAMES)
    cfg = MONO_CFG
  else:
    model = FFModel(FF_CFG, NUM_FRAMES, device="cpu", seed=0)
    _motion(model, ["motion_mlp", "motion_mlp_fine"])
    if kind == "ff":
      model.train_fine()
      opt = trainer.make_ff_optimizer(model, TCFG)
    else:
      model.train_coarse()
      opt = trainer.make_ff_coarse_optimizer(model, TCFG)
    rb = ray_batch.synthetic_ff_batch(FF_CFG, n_rays=N_RAYS, h=32, w=48,
                                      num_frames=NUM_FRAMES, ref_idx=10)
    cfg = FF_CFG
  # anchor view 2 sits at offset 0: its cycle pair compares two roundings
  # of the same point, so its L1 term's gradient is rounding noise
  assert rb["anchor_offset_idx"][2] == 3
  rb["anchor_valid"][2] = 0.0
  _uneven_masks(rb)
  weights = None if kind == "bootstrap" else losses.schedule_weights(TCFG, 0)
  return model, opt, rb, weights, cfg


def run_step(kind: str, mesh=None):
  """One train step of ``kind``: its loss, metrics, the gradients it
  applied and the parameters after it."""
  model, opt, rb, weights, cfg = step_case(kind)
  gen = torch.Generator().manual_seed(STEP_SEED)
  fn = {"mono": trainer.mono_train_step,
        "bootstrap": trainer.mono_train_step,
        "ff": trainer.ff_train_step,
        "ff_coarse": trainer.ff_coarse_train_step}[kind]
  kw = {"bootstrap": True} if kind == "bootstrap" else {}
  loss, metrics, _ = fn(model, opt, rb, weights, cfg, TCFG, generator=gen,
                        mesh=mesh, **kw)
  return {"loss": float(loss),
          "metrics": {k: float(v) for k, v in metrics.items()},
          "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                    if p.grad is not None},
          "params": {k: v.clone() for k, v in model.state_dict().items()}}


def frame_ff(state_dict=None, mesh=None):
  """The FF frame: 24x32 at FRAME_CFG, seeded or given weights."""
  model = FFModel(FRAME_CFG, 48, device="cpu", seed=0)
  if state_dict is not None:
    model.load_state_dict(state_dict)
  rb = ray_batch.synthetic_ff_batch(FRAME_CFG, n_rays=4, h=FRAME_H,
                                    w=FRAME_W, num_frames=48)
  with torch.no_grad():
    c, f = model.encode_featmaps(torch.from_numpy(rb["src_rgbs"]),
                                 torch.from_numpy(rb["static_src_rgbs"]))
  frame = full_image_ray_batch(rb, rb["camera"], device="cpu")
  return render_image_ff(model, frame, c, f, FRAME_CFG, FRAME_CHUNK, FRAME_H,
                         FRAME_W, device="cpu", mesh=mesh)


def frame_mono(mesh=None):
  """The mono frame (its training panels' fields too): 24x32 at
  MONO_CFG, seeded weights."""
  model = MonoModel(MONO_CFG, NUM_FRAMES, device="cpu", seed=0)
  _motion(model, ["motion_mlp"])
  rb = ray_batch.synthetic_mono_batch(MONO_CFG, n_rays=4, h=FRAME_H,
                                      w=FRAME_W, num_frames=NUM_FRAMES)
  rb = full_image_ray_batch(rb, rb["camera"], device="cpu")
  with torch.no_grad():
    fm = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"],
                               rb["anchor_src_rgbs"])
  return render_image_mono(model, rb, fm, MONO_CFG, FRAME_CHUNK, FRAME_H,
                           FRAME_W, train_view=True, device="cpu", mesh=mesh)


def cli_args(root, **kw):
  """The training CLI's arguments on the 7-frame scene ``s`` in ``root``:
  one bootstrap epoch and one full epoch, two loader threads, a panel at
  the last step."""
  base = dict(folder_path=root, train_scenes="s", rootdir=root,
              training_height=SCENE_H, N_rand=8, N_samples=10,
              num_source_views=2, num_vv=1, init_decay_epoch=2, n_iters=7,
              i_img=14, i_weights=100, i_print=7, workers=2, chunk_size=96)
  base.update(kw)
  return ["--device", "cpu"] + [a for k, v in base.items()
                                for a in (f"--{k}", str(v))]


def eval_args(root, results, **kw):
  """The eval CLI's arguments: one frame of the Nvidia scene in ``root``."""
  base = dict(folder_path=root, rootdir=root, eval_scenes="Balloon1",
              training_height=EVAL_H, N_samples=8, N_importance=8,
              compute_dtype="float32", chunk_size=48, max_frames=1,
              results_json=results)
  base.update(kw)
  return (["--config", "configs_nvidia/eval_balloon1_long.txt", "--device",
           "cpu"] + [a for k, v in base.items() for a in (f"--{k}", str(v))])


def ff_cli_args(root, rootdir, **kw):
  """The FF fine-stage CLI's arguments: three steps on the Nvidia scene in
  ``root``, the coarse stage seeded."""
  base = dict(folder_path=root, train_scenes="Balloon1", rootdir=rootdir,
              training_height=EVAL_H, N_rand=8, N_samples=8, N_importance=8,
              num_basis=4, mask_static=False, n_iters=2, i_print=1,
              i_weights=100, workers=2, expname="ff")
  base.update(kw)
  return ["--device", "cpu"] + [a for k, v in base.items()
                                for a in (f"--{k}", str(v))]


def render_args(root, rootdir, snapshot, **kw):
  """The render CLI's arguments: the stabilization path of scene ``s``
  in ``root`` at the session's settings, PNG frames only."""
  base = dict(folder_path=root, train_scenes="s", rootdir=rootdir,
              ckpt_path=snapshot, training_height=SCENE_H,
              num_source_views=2, num_vv=1, N_samples=10, num_basis=4,
              chunk_size=48, video_out="")
  base.update(kw)
  return ["--device", "cpu"] + [a for k, v in base.items()
                                for a in (f"--{k}", str(v))]


def session_config(root):
  return DynibarConfig(folder_path=root, train_scenes=["s"],
                       training_height=SCENE_H, num_source_views=2, num_vv=1,
                       N_samples=10, num_basis=4, chunk_size=48)


def session_requests(session):
  """Two requests: frame 3 off its own pose, and at stride 2 with the
  layers."""
  c2w = np.array(session.data.c2w[3], np.float32)
  c2w[:3, 3] += np.float32(0.013)
  return [dict(c2w=c2w, frame_idx=3),
          dict(c2w=c2w, frame_idx=4, stride=2, layers=True)]


def two_scene_config(root):
  """Scenes ``s`` and ``t`` (a link to ``s``) behind one registry."""
  return dataclasses.replace(session_config(root), train_scenes=["s", "t"])


def concurrent_requests(c2w):
  """Four requests, two to each scene (frame 3, the 7-frame scenes' one
  trainable time) at four poses: ``s`` at stride 1, ``t`` at stride 2,
  so a ``t`` render reaches its gather before an ``s`` render that
  started with it.  No two frames are alike."""
  out = []
  for i in range(4):
    pose = np.array(c2w[3], np.float32)
    pose[:3, 3] += np.float32(0.005 * (i + 1))
    out.append(dict(scene="st"[i % 2], c2w=pose, frame_idx=3,
                    stride=1 + i % 2))
  return out


def _post_all(port, reqs):
  """POST every request at once, from one thread each: (status, rgb)."""
  start = threading.Barrier(len(reqs))

  def post(req):
    body = json.dumps(dict(req, c2w=req["c2w"].tolist(),
                           format="npy")).encode()
    start.wait()
    try:
      with urllib.request.urlopen(urllib.request.Request(
          f"http://127.0.0.1:{port}/render", data=body,
          headers={"Content-Type": "application/json"}), timeout=120) as r:
        return r.status, np.load(io.BytesIO(r.read()))
    except urllib.error.HTTPError as e:
      return e.code, None

  with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
    return list(ex.map(post, reqs))


def serve_two_scenes(mesh, root, state_dict):
  """Rank 0: the concurrent requests through make_server (both sessions
  built first, so the two scenes' renders start together), then the
  followers stopped; the others: follow.  Returns rank 0's (status, rgb)
  per request, the others' count of renders."""
  from dynibar_tpu_torch.serve.registry import SessionRegistry
  from dynibar_tpu_torch.serve.server import make_server
  from dynibar_tpu_torch.serve.session import follow, stop_followers
  registry = SessionRegistry(two_scene_config(root), state_dict=state_dict,
                             device="cpu")
  if not mesh.is_main:
    return follow(registry, mesh)
  for scene in ("s", "t"):
    registry.get(scene)
  httpd = make_server(registry, "127.0.0.1", 0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  try:
    return _post_all(httpd.server_port, concurrent_requests(
        registry.get("s").data.c2w))
  finally:
    httpd.shutdown()
    httpd.server_close()
    stop_followers(mesh)


def run(rank: int, workdir: str) -> None:
  """One rank: every sharded path, its results saved for the test."""
  from dynibar_tpu_torch.cli import (eval_nvidia, render_monocular, train,
                                     train_ff)
  from dynibar_tpu_torch.parallel.mesh import training_mesh
  from dynibar_tpu_torch.serve.registry import SessionRegistry
  from dynibar_tpu_torch.serve.session import (RenderSession, follow,
                                               stop_followers)
  torch.set_num_threads(1)
  mesh = training_mesh(DynibarConfig(mesh_shape=str(WORLD)), "cpu",
                       init_method=f"file://{workdir}/store", rank=rank,
                       world_size=WORLD)
  out = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend}
  out["steps"] = {kind: run_step(kind, mesh) for kind in STEPS}
  out["frame_ff"] = frame_ff(torch.load(os.path.join(workdir, "ff.pt")),
                             mesh)
  out["frame_mono"] = frame_mono(mesh)

  root = os.path.join(workdir, "scenes")
  train_root = os.path.join(workdir, "train2")
  os.makedirs(train_root, exist_ok=True)
  if rank == 0:
    os.symlink(os.path.join(root, "s"), os.path.join(train_root, "s"))
  mesh.all_reduce(torch.zeros(1))            # rank 0's link is there
  out["cli"] = train.main(cli_args(train_root, mesh_shape=WORLD))
  out["eval"] = eval_nvidia.main(eval_args(
      root, os.path.join(workdir, "eval2.json"), mesh_shape="auto"))
  out["train_ff"] = train_ff.main(ff_cli_args(
      root, os.path.join(workdir, "ff2"), mesh_shape=WORLD))
  out["render"] = render_monocular.main(render_args(
      root, os.path.join(workdir, "render2"),
      os.path.join(workdir, "snap", "model_00000001.pt"), mesh_shape=WORLD))

  session = RenderSession(session_config(root),
                          state_dict=torch.load(os.path.join(workdir,
                                                             "mono.pt")),
                          device="cpu")
  if rank == 0:
    out["served"] = [session.render(**r) for r in session_requests(session)]
    stop_followers(mesh)
  else:
    out["served"] = follow(SessionRegistry.from_session(session), mesh)
  out["concurrent"] = serve_two_scenes(
      mesh, root, torch.load(os.path.join(workdir, "mono.pt")))

  errors = {}
  try:
    training_mesh(DynibarConfig(mesh_shape="3"), "cpu")
  except ValueError as e:
    errors["mesh_shape"] = str(e)
  try:
    train.main(cli_args(train_root, mesh_shape=WORLD, N_rand=7))
  except ValueError as e:
    errors["n_rand"] = str(e)
  out["errors"] = errors
  torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
