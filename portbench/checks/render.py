"""What decides ``correct`` in a rendering cell.

A sample of the viewpoints (eval) or frames (render) that the window
produced, drawn from the seed, against the plain reference rendering the
same (frame, camera) from the same weights and the scene's own arrays:

* ``featmap_rel``: the first frame's feature maps (every map the program
  encoded for it) against the reference's, the largest gap over the
  largest reference value;
* ``rgb_max_abs`` and ``rgb_<stat>`` (``img_stats``: the mean, the root
  mean square, the 99.9th percentile, ...): gaps of the rendered rgb;
* (render) ``template_max_abs`` and ``depth_rel``: the session's frame
  state against the scene, and the rendered depth;
* (eval) ``psnr_gap`` and ``ssim_gap``: the PSNR and SSIM that the
  protocol logged for a sampled viewpoint, against the reference's
  scoring of the same prediction (the log prints 2 and 4 decimals).

The workload file's ``limits`` names the numbers that are judged; the
others are printed for the record.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch


def ref_config(ctx):
  from portbench.reference.config import DynibarConfig
  settings = dict(ctx.cell.config["settings"])
  settings["compute_dtype"] = "float32"
  return DynibarConfig(**settings)


def ref_settings(ctx):
  """The reference's render settings for the cell's model, in float32."""
  mode = ctx.cell.config.get("render_mode", "mono")
  return ref_config(ctx).render_settings(mode)


def _ref_model(ctx, weights, num_frames: int):
  from portbench.reference import dynibar as models
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = ref_settings(ctx)
  cls = models.FFModel if ctx.cell.config["model"] == "ff" else models.MonoModel
  model = cls(cfg, num_frames, device=ctx.device)
  model.load_state_dict({k: v.to(ctx.device) for k, v in weights.items()})
  return model, cfg


def img_stats(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
  """Gaps of two images: the largest, the mean, the root mean square, the
  99.9th percentile of the per-pixel largest channel gap, and the share
  of pixels off by more than 0.05 or dark on one side only."""
  d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
  px = d.reshape(-1, d.shape[-1]).max(-1) if d.ndim == 3 else d.reshape(-1)
  dark_a = np.asarray(a).reshape(px.shape[0], -1).sum(-1) == 0
  dark_b = np.asarray(b).reshape(px.shape[0], -1).sum(-1) == 0
  return {"max": float(px.max()), "mean": float(d.mean()),
          "rmse": float(np.sqrt((d ** 2).mean())),
          "p999": float(np.quantile(px, 0.999)),
          "frac_005": float((px > 0.05).mean()),
          "dark_flip": float((dark_a != dark_b).mean())}


def _merge(acc: Dict[str, float], stats: Dict[str, float]) -> None:
  for k, v in stats.items():
    acc[k] = max(acc.get(k, 0.0), v)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
  scale = float(b.abs().max())
  return float((a.to(b.device) - b).abs().max()) / max(scale, 1e-12)


def outliers(got: np.ndarray, other: np.ndarray, want: np.ndarray,
             thr: float = 0.05) -> Dict[str, float]:
  """Of the pixels where ``got`` is off ``want`` by more than ``thr``
  (largest channel gap): how many, the share of them where ``other`` is
  off by more than ``thr`` too, and ``other``'s median gap there."""
  def px(a):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(want, np.float64))
    return d.reshape(-1, d.shape[-1]).max(-1)
  g, o = px(got), px(other)
  hit = g > thr
  n = int(hit.sum())
  return {"n": n, "shared": float((o[hit] > thr).mean()) if n else 0.0,
          "other_median": float(np.median(o[hit])) if n else 0.0}


def eval_readings(ctx, state, sample, control: bool = False,
                  twin: Dict[int, np.ndarray] = None) -> Dict[str, Any]:
  """The eval cell's numbers: the program against the reference; with
  ``control`` the fp8 reference, put in the program's place and scored
  and logged as the protocol does, against it; with ``twin`` (the
  program's bf16 twin's frames) the twin against it and the program's
  outlying pixels beside the twin's."""
  from portbench.reference import nvidia_eval as ref
  from portbench.reference import precision
  scene, logged, views = state["scene"], state["logged"], state["views"]
  sc = ctx.cell.config["scene"]
  settings = ctx.cell.config["settings"]
  mask_static = bool(settings.get("mask_static", False))
  chunk = int(ctx.params.get("reference_chunk", 2048))
  model, cfg = _ref_model(ctx, state["weights"], sc["frames"])
  geo = ref.SceneGeometry(scene, settings["training_height"])
  picks = sample(ctx, len(views), int(ctx.params.get("check_viewpoints", 2)))
  out = {"featmap_rel": 0.0, "rgb_max_abs": 0.0, "psnr_gap": 0.0,
         "ssim_gap": 0.0, "viewpoints": [logged[i][:2] for i in picks]}
  ctrl = {"featmap_rel": 0.0, "rgb_max_abs": 0.0, "psnr_gap": 0.0,
          "ssim_gap": 0.0}
  tw = {"rgb_max_abs": 0.0, "outliers": []}
  frame_fm = {}
  with torch.no_grad():
    for i in picks:
      frame, cam = logged[i][:2]
      tpl = ref.eval_template(scene, geo, frame, cam, cfg.num_views_static,
                              mask_static)
      if frame not in frame_fm:
        frame_fm[frame] = ref.featmaps(model, tpl, mask_static, ctx.device)
      coarse, fine = frame_fm[frame]
      want = ref.render(model, cfg, tpl, coarse, fine, chunk, ctx.device)
      pred = views[i]["rgb"]
      out["rgb_max_abs"] = max(out["rgb_max_abs"],
                               float(np.abs(pred - want).max()))
      _merge(out.setdefault("rgb", {}), img_stats(pred, want))
      gt_path = os.path.join(ctx.scratch, "scene", "dense", "mv_images",
                             f"{frame:05d}", f"cam{cam + 1:02d}.jpg")
      with open(gt_path, "rb") as fh:
        gt_jpeg = fh.read()
      s = ref.scores(pred, gt_jpeg, scene.dyn8(frame, cam))
      out["psnr_gap"] = max(out["psnr_gap"], abs(logged[i][2] - s["psnr"]))
      out["ssim_gap"] = max(out["ssim_gap"], abs(logged[i][3] - s["ssim"]))
      if twin is not None:
        tw["rgb_max_abs"] = max(tw["rgb_max_abs"],
                                float(np.abs(twin[i] - want).max()))
        _merge(tw.setdefault("rgb", {}), img_stats(twin[i], want))
        tw["outliers"].append({"viewpoint": logged[i][:2],
                               "program": outliers(pred, twin[i], want),
                               "twin": outliers(twin[i], pred, want)})
      if control:
        precision.set_fp8(True)
        try:
          low = ref.render(model, cfg, tpl, coarse, fine, chunk, ctx.device)
        finally:
          precision.set_fp8(False)
        ctrl["rgb_max_abs"] = max(ctrl["rgb_max_abs"],
                                  float(np.abs(low - want).max()))
        _merge(ctrl.setdefault("rgb", {}), img_stats(low, want))
        # the control's own frame, logged as the protocol logs (2 and 4
        # decimals), against the reference's scoring of that frame
        sl = ref.scores(low, gt_jpeg, scene.dyn8(frame, cam))
        ctrl["psnr_gap"] = max(ctrl["psnr_gap"],
                               abs(float(f"{sl['psnr']:.2f}") - sl["psnr"]))
        ctrl["ssim_gap"] = max(ctrl["ssim_gap"],
                               abs(float(f"{sl['ssim']:.4f}") - sl["ssim"]))
    first = logged[0][0]
    if state.get("featmaps") is not None:
      if first not in frame_fm:
        tpl = ref.eval_template(scene, geo, first, logged[0][1],
                                cfg.num_views_static, mask_static)
        frame_fm[first] = ref.featmaps(model, tpl, mask_static, ctx.device)
      for got_stage, want_stage in zip(state["featmaps"], frame_fm[first]):
        for got, want in zip(got_stage, want_stage):
          if got is not None and want is not None:
            out["featmap_rel"] = max(out["featmap_rel"], _rel(got, want))
  del model, frame_fm
  if ctx.device.type == "cuda":
    torch.cuda.empty_cache()
  res = {"program": out}
  if control:
    res["control"] = ctrl
  if twin is not None:
    res["twin"] = tw
  return res


def compare_eval(ctx, state, sample) -> List[Dict[str, Any]]:
  from portbench.checks.train import judged
  r = eval_readings(ctx, state, sample)["program"]
  return judged(ctx, flat(r))


def flat(r: Dict[str, Any]) -> Dict[str, Any]:
  """The readings with the image statistics as ``rgb_<stat>``."""
  out = {k: v for k, v in r.items() if k != "rgb"}
  out.update({f"rgb_{k}": v for k, v in r.get("rgb", {}).items()})
  return out


def session_readings(ctx, state, sample, control: bool = False
                     ) -> Dict[str, Any]:
  """The render cell's numbers: each sampled request's frame (the
  session's template for it, checked on its own against the scene: its
  temporal source frames exactly) rendered by the reference from the
  requested camera, and the first request's feature maps."""
  from portbench.reference import precision
  from portbench.reference.cameras import make_camera
  from portbench.reference.render_image import (full_image_ray_batch,
                                                render_image_mono)
  scene, frames = state["scene"], state["frames"]
  templates = state["templates"]
  sc = ctx.cell.config["scene"]
  chunk = int(ctx.params.get("reference_chunk", 2048))
  model, cfg = _ref_model(ctx, state["weights"], sc["frames"])
  picks = sample(ctx, len(frames), int(ctx.params.get("check_frames", 2)))
  out = {"template_max_abs": 0.0, "featmap_rel": 0.0, "rgb_max_abs": 0.0,
         "depth_rel": 0.0, "frames": [frames[i]["idx"] for i in picks]}
  ctrl = {"rgb_max_abs": 0.0, "depth_rel": 0.0}

  def draw(tpl, camera):
    src = torch.as_tensor(tpl["src_rgbs"], device=ctx.device)
    st = torch.as_tensor(tpl["static_src_rgbs"], device=ctx.device)
    fm = model.encode_featmaps(src, st)
    rb = full_image_ray_batch(tpl, camera, device=ctx.device)
    ret = render_image_mono(model, rb, fm, cfg, chunk, sc["height"],
                            sc["width"], device=ctx.device)
    return fm, ret["outputs_coarse_ref"]

  with torch.no_grad():
    for n, i in enumerate(picks):
      f = frames[i]
      tpl = templates[f["idx"]]
      offs = np.asarray(tpl["src_offset_idx"]) - 3
      for j in range(6):
        k = int(np.clip(f["idx"] + int(offs[j]), 0, sc["frames"] - 1))
        want = scene.image8(k).astype(np.float32) / 255.0
        out["template_max_abs"] = max(
            out["template_max_abs"],
            float(np.abs(np.asarray(tpl["src_rgbs"][j]) - want).max()))
      pose = np.eye(4, dtype=np.float32)
      pose[:3] = f["pose"]
      camera = make_camera(sc["height"], sc["width"], f["intr"], pose)
      fm, ref = draw(tpl, camera)
      out["rgb_max_abs"] = max(out["rgb_max_abs"],
                               float(np.abs(f["rgb"] - ref["rgb"]).max()))
      _merge(out.setdefault("rgb", {}), img_stats(f["rgb"], ref["rgb"]))
      scale = float(np.abs(ref["depth"]).max())
      out["depth_rel"] = max(out["depth_rel"], float(
          np.abs(f["depth"] - ref["depth"]).max()) / max(scale, 1e-12))
      if i == 0 and state.get("featmaps") is not None:
        for got, want in zip(state["featmaps"], fm):
          if got is not None and want is not None:
            out["featmap_rel"] = max(out["featmap_rel"], _rel(got, want))
      if control:
        precision.set_fp8(True)
        try:
          _, low = draw(tpl, camera)
        finally:
          precision.set_fp8(False)
        ctrl["rgb_max_abs"] = max(ctrl["rgb_max_abs"], float(
            np.abs(low["rgb"] - ref["rgb"]).max()))
        _merge(ctrl.setdefault("rgb", {}), img_stats(low["rgb"], ref["rgb"]))
        ctrl["depth_rel"] = max(ctrl["depth_rel"], float(
            np.abs(low["depth"] - ref["depth"]).max()) / max(scale, 1e-12))
  del model
  if ctx.device.type == "cuda":
    torch.cuda.empty_cache()
  res = {"program": out}
  if control:
    res["control"] = ctrl
  return res


def compare_session(ctx, state, sample) -> List[Dict[str, Any]]:
  from portbench.checks.train import judged
  r = session_readings(ctx, state, sample)["program"]
  return judged(ctx, flat(r))
