"""Eval traffic: the Nvidia protocol, one viewpoint frame after another.

Drives ``eval/nvidia_eval.evaluate_scene`` as it is, over a 24-frame
Nvidia-layout scene written from the seed, with FF weights the benchmark
makes, ``kernels=True`` and no LPIPS weights: frames 3 .. N-4, each
frame's feature maps once, then for each of its 11 scored viewpoints
``render_image_ff`` at the configuration's chunk and the masked
PSNR / SSIM.  One viewpoint frame is one unit.  The window ends at the
first viewpoint that finishes after ``--seconds``: the protocol's own
``log_fn`` reports each viewpoint, and the driver stops the protocol
there.

The benchmark's spans wrap the program's calls into its layers: the
feature maps (``encode_featmaps``) and the render (``render_image_ff``),
whose outputs it keeps for the check.  ``check`` frees the program's
state and renders a sample of the window's viewpoints, drawn from the
seed, with the reference (``portbench/checks/render.py``).

Traffic parameters: ``warm_viewpoints``, ``check_viewpoints``,
``trace_units``, ``reference_chunk``.
"""

from __future__ import annotations

import gc
import re
import time
from typing import Any, Dict

import numpy as np
import torch

from portbench.drivers.train_loop import _seeds, build_kernels
from portbench.scenes.nvidia import NvidiaScene

_VIEW = re.compile(r"^frame (\d+) cam (\d+): psnr=([-\d.a-z]+) "
                   r"ssim=([-\d.a-z]+)")


class _StopWindow(Exception):
  """Raised from the protocol's log to end the window at a viewpoint."""


def _config(ctx, folder: str):
  from dynibar_tpu_torch.config import DynibarConfig
  settings = dict(ctx.cell.config["settings"])
  settings.update(folder_path=folder, eval_scenes=["scene"])
  return DynibarConfig(**settings)


def setup(ctx) -> Dict[str, Any]:
  from dynibar_tpu_torch.eval import nvidia_eval
  from dynibar_tpu_torch.models.dynibar import FFModel
  from portbench.checks.render import ref_settings
  from portbench.reference import dynibar as ref_models
  from portbench.weights import make_weights

  seeds = _seeds(ctx.seed)
  build_kernels(ctx)
  sc = ctx.cell.config["scene"]
  with ctx.span("scene_write"):
    t0 = time.perf_counter()
    scene = NvidiaScene(seeds["scene"], sc["frames"], sc["height"],
                        sc["width"], sc["focal"])
    wrote = scene.write(ctx.scratch, "scene")
    ctx.note(f"scene: wrote {wrote['bytes']} bytes in {wrote['files']} "
             f"files in {time.perf_counter() - t0:.3f} s")
  config = _config(ctx, ctx.scratch)
  cfg = config.render_settings("ff")
  rcfg = ref_settings(ctx)
  template = ref_models.FFModel(rcfg, sc["frames"], device="cpu")
  weights = make_weights(template, seeds["weights"], ctx.device)
  del template
  model = FFModel(cfg, sc["frames"], device=ctx.device)
  model.load_state_dict(weights)
  state = {"model": model, "config": config, "scene": scene,
           "weights": {k: v.detach().cpu() for k, v in weights.items()},
           "views": [], "featmaps": None, "nvidia_eval": nvidia_eval,
           "keep": False}
  del weights
  _install_spies(ctx, state)
  with ctx.span("warm_up"):
    _protocol(state, ctx, seconds=None,
              units=int(ctx.params.get("warm_viewpoints", 1)))
  state["views"].clear()
  state["featmaps"] = None
  state["keep"] = True
  return state


def _install_spies(ctx, state) -> None:
  """Wrap the program's calls into its layers in the benchmark's spans,
  keeping their outputs for the check."""
  ev = state["nvidia_eval"]
  model = state["model"]
  render = ev.render_image_ff
  encode = model.encode_featmaps

  def render_spy(*args, **kw):
    with ctx.span("render"):
      ret = render(*args, **kw)
    if state["keep"]:
      state["views"].append({"rgb": ret["outputs_fine_ref"]["rgb"]})
    return ret

  def encode_spy(*args, **kw):
    with ctx.span("featmaps"):
      out = encode(*args, **kw)
    if state["keep"] and state["featmaps"] is None:
      state["featmaps"] = [[None if t is None else t.detach().clone()
                            for t in stage] for stage in out]
    return out

  state["restore"] = (render, encode)
  ev.render_image_ff = render_spy
  model.encode_featmaps = encode_spy


def _protocol(state, ctx, seconds, units) -> Dict[str, Any]:
  """Run the protocol until ``seconds`` have passed or ``units``
  viewpoints are done; returns the viewpoints' times and log records."""
  ev = state["nvidia_eval"]
  rec = {"n": 0, "logged": [], "t_end": None}
  t0 = time.perf_counter()

  def log_fn(line: str) -> None:
    m = _VIEW.match(line)
    if not m:
      return
    rec["n"] += 1
    rec["t_end"] = time.perf_counter()
    rec["logged"].append((int(m.group(1)), int(m.group(2)),
                          float(m.group(3)), float(m.group(4))))
    ctx.unit_done()
    if units is not None and rec["n"] >= units:
      raise _StopWindow
    if seconds is not None and rec["t_end"] - t0 >= seconds:
      raise _StopWindow

  with ctx.span("protocol"):
    try:
      ev.evaluate_scene(state["config"], state["model"], "scene",
                        lpips_weights_dir=None, log_fn=log_fn,
                        device=ctx.device, kernels=True)
    except _StopWindow:
      pass
  rec["t0"] = t0
  return rec


def window(state, ctx, seconds=None, units=None) -> Dict[str, Any]:
  if ctx.device.type == "cuda":
    torch.cuda.synchronize(ctx.device)
  rec = _protocol(state, ctx, seconds, units)
  n = rec["n"]
  t = rec["t_end"] - rec["t0"]
  state["logged"] = rec["logged"]
  return {"units": n, "seconds": t, "frame_s": t / n}


def work(ctx, state) -> Dict[str, Any]:
  """The shapes of one viewpoint frame: the coarse (S) and fine (S + I)
  aggregators over every pixel, the motion MLPs, and a share (1/11) of
  the frame's feature maps (two nets over 7 + 11 views)."""
  from portbench.checks.render import ref_settings
  cfg = ref_settings(ctx)
  sc = ctx.cell.config["scene"]
  r = sc["height"] * sc["width"]
  c = 3 + cfg.coarse_feat_dim
  s0, s1 = cfg.n_samples, cfg.n_samples + cfg.n_importance
  v_dy, v_st = cfg.num_views_dy, cfg.num_views_static
  share = 1.0 / 11.0
  views = v_dy + v_st
  return {"agg": [(True, r, s0, v_st, c, False), (False, r, s0, v_dy, c, False),
                  (True, r, s1, v_st, c, False), (False, r, s1, v_dy, c, False)],
          "featnet": [(views, sc["height"], sc["width"], False)] * 2,
          "featnet_share": share,
          "motion": [(r * s0, False), (r * s1, False)]}


def close(state) -> None:
  restore = state.get("restore")
  if restore is not None and "model" in state:
    state["nvidia_eval"].render_image_ff = restore[0]
    state["model"].__dict__.pop("encode_featmaps", None)


def _release(state, ctx) -> None:
  close(state)
  state.pop("model", None)
  state.pop("restore", None)
  gc.collect()
  if ctx.device.type == "cuda":
    torch.cuda.empty_cache()


def _sample(ctx, n: int, k: int):
  """k of the window's n viewpoints, drawn from the seed; the first and
  the last always among them when k >= 2."""
  rng = np.random.RandomState(ctx.seed % (2 ** 32))
  if n <= k:
    return list(range(n))
  picks = {0, n - 1} if k >= 2 else set()
  rest = [i for i in range(n) if i not in picks]
  picks |= set(rng.choice(rest, size=k - len(picks), replace=False).tolist())
  return sorted(picks)


def check(state, ctx):
  from portbench.checks import render as render_check
  _release(state, ctx)
  return render_check.compare_eval(ctx, state, _sample)


def _twin_views(state, ctx) -> Dict[int, np.ndarray]:
  """The sampled viewpoints rendered again by the program through the
  aggregators' bf16 twin (plain PyTorch, ``kernels=BF16_TWIN``), the
  frame's data and feature maps made as the protocol makes them: a
  second witness beside the kernels for what bf16 does to a frame."""
  from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
  from dynibar_tpu_torch.models.dynibar import BF16_TWIN
  from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                     render_image_ff)
  config, model, dev = state["config"], state["model"], ctx.device
  data = NvidiaSceneData(config, "scene", height=config.training_height)
  chunk = int(ctx.params.get("reference_chunk", 2048))
  picks = _sample(ctx, len(state["views"]),
                  int(ctx.params.get("check_viewpoints", 2)))
  out, featmaps = {}, {}
  with torch.no_grad():
    for i in picks:
      frame, cam = state["logged"][i][:2]
      if frame not in featmaps:
        tpl = data.eval_batch(frame, 0)
        src = torch.as_tensor(tpl["src_rgbs"], device=dev)
        st = torch.as_tensor(tpl["static_src_rgbs"], device=dev)
        st_masked = st
        if config.mask_static:
          st_masked = st * torch.as_tensor(tpl["static_src_masks"],
                                           device=dev)[..., None]
        featmaps[frame] = model.encode_featmaps(
            src, st, fine_static_src_rgbs=st_masked)
      batch = data.eval_batch(frame, cam)
      rb = {k: v for k, v in batch.items() if k != "static_src_masks"}
      rb = full_image_ray_batch(rb, rb["camera"], device=dev)
      h, w = int(batch["camera"][0]), int(batch["camera"][1])
      ret = render_image_ff(model, rb, *featmaps[frame], model.cfg, chunk,
                            h, w, device=dev, kernels=BF16_TWIN)
      out[i] = ret["outputs_fine_ref"]["rgb"]
  return out


def control_readings(state, ctx, control: bool, twin: bool = False):
  from portbench.checks import render as render_check
  # the readings come from a short window, as a run's check does
  window(state, ctx, seconds=None,
         units=int(ctx.params.get("check_viewpoints", 2)))
  twins = _twin_views(state, ctx) if twin else None
  _release(state, ctx)
  return render_check.eval_readings(ctx, state, _sample, control=control,
                                    twin=twins)
