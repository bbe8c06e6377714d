"""Render traffic: a video rendered frame by frame through the session.

Drives ``serve/session.RenderSession.render`` in-process, with weights
the benchmark makes passed as ``state_dict`` and the default
``featmap_cache``, over a monocular scene written from the seed.  Request
k asks for a full frame at video time ``first + k mod span`` with a pose
on a smooth path around that frame's camera, so each request builds its
frame's state (source stack, feature maps, template): the traffic of
``cli/render_monocular`` or of a viewer scrubbing through time.  One
request is one unit; the window ends with the first request that
finishes after ``--seconds``.

The benchmark's spans wrap its calls into the session and the session's
call into the template builder (``render_batch_template``), whose output
it keeps for the check: the reference follows the session's own choice
of virtual views from there (``portbench/checks/render.py``).

Traffic parameters: ``first_frame``, ``last_frame`` (from the end),
``radius``, ``warm_requests``, ``check_frames``, ``trace_units``,
``reference_chunk``.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict

import numpy as np
import torch

from portbench.drivers.nvidia_eval import _sample
from portbench.drivers.train_loop import _seeds, build_kernels
from portbench.scenes.mono import MonoScene


def _config(ctx, folder: str):
  from dynibar_tpu_torch.config import DynibarConfig
  settings = dict(ctx.cell.config["settings"])
  settings.update(ctx.cell.config.get("render", {}).get("settings", {}))
  settings.update(folder_path=folder, train_scenes=["scene"])
  return DynibarConfig(**settings)


def request_path(ctx, scene, num_frames: int):
  """(frame, c2w [3, 4]) of request k, in the scene's recentred
  convention, worked out by the benchmark from the scene's poses."""
  from portbench.reference import llff
  meta = llff.load_scene_poses(scene.poses_bounds(), (scene.h, scene.w),
                               height=scene.h, with_vv=True,
                               src_vv_poses_file=scene.vv_poses())
  intr, c2w = llff.batch_parse_llff_poses(meta["poses"])
  first = int(ctx.params.get("first_frame", 3))
  last = num_frames - int(ctx.params.get("last_frame", 4))
  span = last - first + 1
  radius = float(ctx.params.get("radius", 0.02))

  def request(k: int):
    idx = first + k % span
    pose = np.asarray(c2w[idx], np.float64)[:3, :4].copy()
    ang = 2.0 * np.pi * k / span
    pose[:, 3] += radius * np.array([np.cos(ang), np.sin(ang), 0.0])
    return idx, pose.astype(np.float32), np.asarray(intr[idx], np.float32)
  return request


def setup(ctx) -> Dict[str, Any]:
  from dynibar_tpu_torch.serve import session as session_mod
  from portbench.checks.render import ref_settings
  from portbench.reference import dynibar as ref_models
  from portbench.weights import make_weights

  seeds = _seeds(ctx.seed)
  build_kernels(ctx)
  sc = ctx.cell.config["scene"]
  with ctx.span("scene_write"):
    t0 = time.perf_counter()
    scene = MonoScene(seeds["scene"], sc["frames"], sc["height"],
                      sc["width"], sc["focal"])
    wrote = scene.write(ctx.scratch, "scene")
    ctx.note(f"scene: wrote {wrote['bytes']} bytes in {wrote['files']} "
             f"files in {time.perf_counter() - t0:.3f} s")
  config = _config(ctx, ctx.scratch)
  template = ref_models.MonoModel(ref_settings(ctx), sc["frames"],
                                  device="cpu")
  weights = make_weights(template, seeds["weights"], ctx.device)
  del template
  sess = session_mod.RenderSession(config, state_dict=weights,
                                   device=ctx.device)
  state = {"session": sess, "session_mod": session_mod, "scene": scene,
           "weights": {k: v.detach().cpu() for k, v in weights.items()},
           "request": request_path(ctx, scene, sc["frames"]),
           "frames": [], "keep": False, "k": 0}
  del weights
  _install_spy(ctx, state)
  warm = int(ctx.params.get("warm_requests", 2))
  with ctx.span("warm_up"):
    for j in range(warm):
      # the path's last frames: the window starts at its first
      idx, pose, intr = state["request"](-1 - j)
      sess.render(pose, idx, intrinsics=intr)
  state["keep"] = True
  return state


def _install_spy(ctx, state) -> None:
  mod = state["session_mod"]
  build = mod.render_batch_template

  def spy(*args, **kw):
    with ctx.span("frame_state"):
      out = build(*args, **kw)
    state["templates"][int(out["ref_frame_idx"])] = out
    return out

  model = state["session"].model
  encode = model.encode_featmaps

  def encode_spy(*args, **kw):
    out = encode(*args, **kw)
    if state["keep"] and state["featmaps"] is None:
      state["featmaps"] = [None if f is None else f.detach().clone()
                           for f in out]
    return out

  state["templates"] = {}
  state["featmaps"] = None
  state["restore"] = build
  mod.render_batch_template = spy
  model.encode_featmaps = encode_spy


def window(state, ctx, seconds=None, units=None) -> Dict[str, Any]:
  sess = state["session"]
  if ctx.device.type == "cuda":
    torch.cuda.synchronize(ctx.device)
  n = 0
  t0 = time.perf_counter()
  while True:
    idx, pose, intr = state["request"](state["k"])
    with ctx.span("render"):
      out = sess.render(pose, idx, intrinsics=intr)
    state["frames"].append({"idx": idx, "pose": pose, "intr": intr,
                            "rgb": out["rgb"], "depth": out["depth"]})
    state["k"] += 1
    n += 1
    ctx.unit_done()
    if units is not None and n >= units:
      break
    if seconds is not None and time.perf_counter() - t0 >= seconds:
      break
  t = time.perf_counter() - t0
  return {"units": n, "seconds": t, "frame_s": t / n}


def work(ctx, state) -> Dict[str, Any]:
  """One full frame: the static and dynamic aggregators over every pixel,
  the motion MLP, and the frame's feature maps (two nets over the 9
  dynamic and 14 static views)."""
  from portbench.checks.render import ref_settings
  cfg = ref_settings(ctx)
  sc = ctx.cell.config["scene"]
  r = sc["height"] * sc["width"]
  c = 3 + cfg.coarse_feat_dim
  s = cfg.n_samples
  return {"agg": [(True, r, s, cfg.num_views_static, c, False),
                  (False, r, s, cfg.num_views_dy, c, False)],
          "featnet": [(cfg.num_views_dy, sc["height"], sc["width"], False),
                      (cfg.num_views_static, sc["height"], sc["width"],
                       False)],
          "motion": [(r * s, False)]}


def close(state) -> None:
  if "restore" in state:
    state["session_mod"].render_batch_template = state.pop("restore")


def _release(state, ctx) -> None:
  close(state)
  state.pop("session", None)
  gc.collect()
  if ctx.device.type == "cuda":
    torch.cuda.empty_cache()


def check(state, ctx):
  from portbench.checks import render as render_check
  _release(state, ctx)
  return render_check.compare_session(ctx, state, _sample)


def control_readings(state, ctx, control: bool):
  from portbench.checks import render as render_check
  window(state, ctx, seconds=None,
         units=int(ctx.params.get("check_frames", 2)))
  _release(state, ctx)
  return render_check.session_readings(ctx, state, _sample, control=control)
