"""Frozen copy of dynibar_tpu_torch/render/render_rays.py at commit a749e58, part
of the benchmark's plain reference (portbench/reference/__init__.py).

The render cores: FF (frozen coarse -> importance -> fine (-> anchor)),
FF coarse (one stage (-> anchor)) and mono (one stage (-> anchor)).

Port of ``dynibar_tpu.render.render_rays.render_rays_mv``,
``render_rays_mono``, ``render_rays_ff_coarse``, ``_render_stage_ff`` and
``_cross_time_branch`` (reference render_ray.py:407-1270).  The eval call runs everything under
``torch.no_grad()``: each stage samples the source views through K1
(ops/sample.py) and aggregates through K2/K3 (ops/agg.py).  The train call
(``is_train=True``) keeps the frozen coarse stage there and runs the fine
stage and its cross-time (anchor) branch with autograd on: the sampler is
``F.grid_sample`` (the JAX grad path's routing, render_rays.py:112-122)
and the aggregators go through their autograd Functions (K2r/K3r forward,
K5a/K5b and K4a/K4b backward).  ``kernels=False`` runs the plain twins
instead, which is how the kernels are held against them on the card;
``kernels=BF16_TWIN`` (models/dynibar.py) samples as False does and runs
the aggregators' bf16 twin: the JAX package's flax aggregators at
``compute_dtype="bfloat16"``.
``render_rays_mono`` runs its one stage the same way: no autograd unless
``needs_grad`` (by default ``is_train``) asks for it, so the bootstrap
step renders with ``is_train=False`` and still differentiates.  The mono
model passes ``None`` where the FF model names its stage.
``render_rays_ff_coarse`` is the same single-stage render on the FF
model's coarse nets: the program that trains its coarse stage.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from portbench.reference.config import RenderSettings
from portbench.reference import composite as comp
from portbench.reference import motion
from portbench.reference import projection as proj
from portbench.reference import sampling
from portbench.reference.dynibar import Kernels, launches_kernels
from portbench.reference.sample import sample_views_plain
from portbench.reference import precision
from portbench.reference.device import (DeviceLike, resolve_device,
                                            to_device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
  return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                         min=1e-12)


def _sampling_cast(cfg: RenderSettings, imgs, feats):
  """bf16 mode samples images and features in bf16 (half the bytes);
  projection and masks stay f32."""
  if cfg.compute_dtype == "bfloat16":
    return imgs.to(torch.bfloat16), feats.to(torch.bfloat16)
  return precision.round_maps(imgs), precision.round_maps(feats)


def _sample_fn(kernels: Kernels):
  """The reference samples through F.grid_sample alone."""
  return sample_views_plain


def _time_emb(t: torch.Tensor, n_rays: int, s: int) -> torch.Tensor:
  return t.reshape(1, 1, 1).expand(n_rays, s, 1)


def _motion_window(model, stage, pts, time_emb, frame_idx, window):
  """MotionMLP -> tail-zeroed coeffs -> trajectory points [R,S,O,3]."""
  raw_coeff = model.apply_motion(stage, torch.cat([pts, time_emb], dim=-1))
  raw_coeff = motion.zero_tail_coeffs(raw_coeff, pts.shape[1])
  basis_win = motion.basis_window(model.basis(stage), frame_idx, window)
  return motion.traj_points_window(raw_coeff, basis_win)


def stage_inputs(model, rb, featmaps, cfg: RenderSettings,
                 stage: Optional[str], pts, kernels: Kernels = True
                 ) -> Dict[str, Any]:
  """Everything one stage hands its aggregators: trajectories, displaced
  points, sampled features (through K1 for no-grad kernel passes), masks
  and encodings (reference fine_render_rays, render_ray.py:407-597)."""
  w = cfg.traj_window
  n_rays, s = pts.shape[:2]
  time_emb = _time_emb(rb["ref_time"], n_rays, s)
  traj = _motion_window(model, stage, pts, time_emb, rb["ref_frame_idx"], w)
  pts_seq = motion.displaced_points(pts, traj, rb["src_offset_idx"], w)
  pts_static = pts[None].expand((cfg.num_views_static,) + pts.shape)
  sample_fn = _sample_fn(kernels)

  src_imgs, src_feats = _sampling_cast(cfg, rb["src_rgbs"], featmaps[0])
  st_imgs, st_feats = _sampling_cast(cfg, rb["static_src_rgbs"], featmaps[2])
  rgb_feat, _, mask = proj.compute_with_motions(
      pts, pts_seq, rb["camera"], src_imgs, rb["src_cameras"], src_feats,
      rb["src_valid"], sample_fn)
  rgb_feat_st, ray_diff_st, mask_st = proj.compute_with_motions(
      pts, pts_static, rb["camera"], st_imgs, rb["static_src_cameras"],
      st_feats, rb["static_valid"], sample_fn)
  return {
      "traj": traj, "pts_seq": pts_seq,
      "dy": (pts, rgb_feat, _normalize(rb["ray_d"]), mask, time_emb),
      "st": (pts, proj.ref_plucker(rb["ray_o"], rb["ray_d"]),
             proj.src_plucker(pts, rb["static_src_cameras"]), rgb_feat_st,
             ray_diff_st, mask_st),
  }


def _render_stage_ff(model, rb, featmaps, cfg: RenderSettings,
                     stage: Optional[str], pts, z_vals, kernels: Kernels
                     ) -> Dict[str, Any]:
  """One stage's forward (FF coarse/fine, or mono with stage None): stage
  inputs -> K3/K2 -> composite.  Under autograd the stage is recomputed
  in the backward (``torch.utils.checkpoint``), so that the reference's
  f32 train step fits on one card; the gradients are the same."""
  if torch.is_grad_enabled():
    return torch.utils.checkpoint.checkpoint(
        _render_stage_body, model, rb, featmaps, cfg, stage, pts, z_vals,
        kernels, use_reentrant=False)
  return _render_stage_body(model, rb, featmaps, cfg, stage, pts, z_vals,
                            kernels)


def _render_stage_body(model, rb, featmaps, cfg: RenderSettings,
                       stage: Optional[str], pts, z_vals, kernels: Kernels
                       ) -> Dict[str, Any]:
  ins = stage_inputs(model, rb, featmaps, cfg, stage, pts, kernels)
  mask, mask_st = ins["dy"][3], ins["st"][5]
  pixel_mask = torch.sum(mask[..., 0].float(), dim=2) > 1
  pixel_mask_st = torch.sum(mask_st[..., 0].float(), dim=2) > 1
  raw_dy = model.apply_dy(stage, *ins["dy"], kernels=kernels)
  raw_st = model.apply_st(stage, *ins["st"], kernels=kernels)
  return {
      "outputs": comp.composite_dual(raw_dy, raw_st, z_vals, pixel_mask,
                                     pixel_mask_st),
      "outputs_dy": comp.composite_single(raw_dy, z_vals, pixel_mask),
      "traj": ins["traj"], "pts_seq": ins["pts_seq"], "raw_st": raw_st,
      "pixel_mask_st": pixel_mask_st,
  }


def _cross_time_branch(model, rb, cfg: RenderSettings, stage: Optional[str],
                       anchor_featmaps, stage_out: Dict[str, Any], pts_ref,
                       z_vals, kernels: Kernels):
  """Cross-time (anchor) rendering for the temporal-consistency losses
  (dynibar_tpu render_rays.py:272-363) of the model's `stage` (FF "fine",
  mono None): the reference points displaced to the anchor time along
  their trajectory, rendered from the anchor views, the matched
  trajectory pairs with their validity, and the occlusion weights (no
  gradient)."""
  w = cfg.traj_window
  n_rays, s = pts_ref.shape[:2]
  traj_ref = stage_out["traj"]
  delta = (rb["anchor_frame_idx"] - rb["ref_frame_idx"]).reshape(1)
  sf_seq = motion.scene_flow_seq(traj_ref)                     # [2w,R,S,3]

  traj_at_delta = torch.index_select(traj_ref, 2, delta + w)[:, :, 0]
  pts_anchor = pts_ref + traj_at_delta - traj_ref[:, :, w]
  anchor_time_emb = _time_emb(rb["anchor_time"], n_rays, s)
  traj_anchor = _motion_window(model, stage, pts_anchor, anchor_time_emb,
                               rb["anchor_frame_idx"], w)
  pts_seq_anchor = motion.displaced_points(
      pts_anchor, traj_anchor, rb["anchor_offset_idx"], w)      # [Va,R,S,3]

  # matched pairs: for each real anchor view at offset o, the reference-time
  # twin sits at offset delta + o
  ref_off_idx = delta + rb["anchor_offset_idx"].long()          # [Va]
  pair_valid = ((rb["anchor_valid"] > 0) & (rb["anchor_is_vv"] < 1)
                & (ref_off_idx >= 0) & (ref_off_idx <= 2 * w))
  ref_off_idx = torch.clamp(ref_off_idx, 0, 2 * w)
  traj_ref_sel = torch.index_select(traj_ref, 2, ref_off_idx)  # [R,S,Va,3]
  pts_traj_ref = ((traj_ref_sel - traj_ref[:, :, w:w + 1]).permute(2, 0, 1, 3)
                  + pts_ref[None])

  a_imgs, a_feats = _sampling_cast(cfg, rb["anchor_src_rgbs"],
                                   anchor_featmaps)
  rgb_feat_a, _, mask_a = proj.compute_with_motions(
      pts_ref, pts_seq_anchor, rb["camera"], a_imgs,
      rb["anchor_src_cameras"], a_feats, rb["anchor_valid"],
      _sample_fn(kernels))
  # the anchor pixel mask uses > 0 (reference render_ray.py:1198-1200)
  pixel_mask_a = torch.sum(mask_a[..., 0].float(), dim=2) > 0
  raw_anchor = model.apply_dy(stage, pts_anchor, rgb_feat_a,
                              _normalize(rb["ray_d"]), mask_a,
                              anchor_time_emb, kernels=kernels)
  out_a = comp.composite_dual(raw_anchor, stage_out["raw_st"], z_vals,
                              pixel_mask_a, stage_out["pixel_mask_st"])
  out_a_dy = comp.composite_single(raw_anchor, z_vals, pixel_mask_a)

  out_ref, out_ref_dy = stage_out["outputs"], stage_out["outputs_dy"]
  occ_dy = (out_ref_dy["weights"] - out_a_dy["weights"]).detach()
  out_a_dy["occ_weights"] = 1.0 - torch.abs(occ_dy)
  out_a_dy["occ_weight_map"] = 1.0 - torch.abs(torch.sum(occ_dy, dim=1))
  # disocclusion weights (reference render_ray.py:1232-1257)
  diff_dy = out_ref["weights_dy"] - out_a["weights_dy"]
  diff_full = out_ref["weights"] - out_a["weights"]
  if cfg.occ_weights_mode == 0:     # mix: dy-composite unless |dt| <= 1
    occ = torch.where(delta.abs() > 1, diff_dy, diff_full)
  elif cfg.occ_weights_mode == 1:   # composite-dy
    occ = diff_dy
  elif cfg.occ_weights_mode == 2:   # full
    occ = diff_full
  else:
    raise NotImplementedError(cfg.occ_weights_mode)
  occ = occ.detach()
  out_a["occ_weights"] = 1.0 - torch.abs(occ)
  out_a["occ_weight_map"] = 1.0 - torch.abs(torch.sum(occ, dim=1))
  out_a["pts_traj_ref"] = pts_traj_ref
  out_a["pts_traj_anchor"] = pts_seq_anchor
  out_a["pair_valid"] = pair_valid
  out_a["sf_seq"] = sf_seq
  return out_a, out_a_dy


def render_rays_mv(model, rb: Dict[str, Any], coarse_featmaps,
                   fine_featmaps, cfg: RenderSettings, *,
                   device: DeviceLike = None, kernels: Kernels = True,
                   is_train: bool = False, det: bool = True,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
  """Coarse->fine forward of the forward-facing model for one ray batch
  (reference render_rays_mv, render_ray.py:600-867).

  rb: ray-batch dict (numpy or tensors, see data/ray_batch.py);
  featmaps: (dynamic, anchor or None, static) per stage, [V, Hf, Wf, C].
  Eval (is_train=False) runs without autograd.  is_train=True adds the
  fine-stage cross-time branch and records the fine stage for the
  backward; the coarse stage stays frozen.  det=False places the samples
  stochastically from ``generator``.
  """
  dev = resolve_device(device)
  if model.device != dev:
    raise ValueError(f"model is on {model.device}, render asked for {dev}")
  rb = to_device(rb, dev)
  with torch.no_grad():
    pts, z_vals, _ = sampling.sample_along_ray(
        rb["ray_o"], rb["ray_d"], rb["depth_range"], cfg.n_samples,
        inv_uniform=cfg.inv_uniform, det=det, generator=generator)
    coarse = _render_stage_ff(model, rb, coarse_featmaps, cfg, "coarse",
                              pts, z_vals, kernels)
    z_all = sampling.importance_resample_z(
        z_vals, coarse["outputs"]["weights"], cfg.n_importance,
        inv_uniform=cfg.inv_uniform, det=det, generator=generator)
  near, far = rb["depth_range"][0], rb["depth_range"][1]
  pts_fine = z_all[..., None] * rb["ray_d"][:, None, :] + rb["ray_o"][:, None]
  with torch.set_grad_enabled(is_train and torch.is_grad_enabled()):
    fine = _render_stage_ff(model, rb, fine_featmaps, cfg, "fine", pts_fine,
                            z_all, kernels)
    outputs_fine = fine["outputs"]
    outputs_fine["render_flows"] = comp.render_optical_flow(
        outputs_fine["weights"], fine["pts_seq"], rb["src_cameras"],
        rb["uv_grid"])
    outputs_fine["s_vals"] = sampling.z_to_s(z_all, near, far)
    outputs_fine["exp_sf"] = motion.expected_scene_flow(
        outputs_fine["weights"], fine["traj"], 2, cfg.traj_window)
    ret = {
        "outputs_coarse_ref": coarse["outputs"],
        "outputs_fine_ref": outputs_fine,
        "outputs_fine_ref_dy": fine["outputs_dy"],
    }
    if is_train:
      ret["outputs_fine_anchor"], ret["outputs_fine_anchor_dy"] = (
          _cross_time_branch(model, rb, cfg, "fine", fine_featmaps[1], fine,
                             pts_fine, z_all, kernels))
  return ret


def _render_one_stage(model, rb, featmaps, cfg: RenderSettings,
                      stage: Optional[str], *, kernels: Kernels, is_train: bool,
                      det: bool, generator: Optional[torch.Generator],
                      needs_grad: bool, flow_views: Optional[int],
                      sf_step: int, static_composite: bool
                      ) -> Dict[str, Any]:
  """A single-stage render (uniform samples, dual composite, rendered
  flows against the first ``flow_views`` sources (all with None), s_vals,
  a detached expected scene flow over ``sf_step`` frames) and, with
  is_train, the cross-time branch at the same nets; autograd on when
  ``needs_grad``."""
  with torch.set_grad_enabled(needs_grad and torch.is_grad_enabled()):
    pts, z_vals, s_vals = sampling.sample_along_ray(
        rb["ray_o"], rb["ray_d"], rb["depth_range"], cfg.n_samples,
        inv_uniform=cfg.inv_uniform, det=det, generator=generator)
    out_stage = _render_stage_ff(model, rb, featmaps, cfg, stage, pts,
                                 z_vals, kernels)
    out = out_stage["outputs"]
    out["render_flows"] = comp.render_optical_flow(
        out["weights"], out_stage["pts_seq"][:flow_views],
        rb["src_cameras"][:flow_views], rb["uv_grid"])
    out["s_vals"] = s_vals
    out["exp_sf"] = motion.expected_scene_flow(
        out["weights"], out_stage["traj"], sf_step, cfg.traj_window).detach()
    ret = {"outputs_coarse_ref": out,
           "outputs_coarse_ref_dy": out_stage["outputs_dy"]}
    if static_composite:
      ret["outputs_coarse_st"] = comp.composite_single(
          out_stage["raw_st"], z_vals, out_stage["pixel_mask_st"])
    if is_train:
      ret["outputs_coarse_anchor"], ret["outputs_coarse_anchor_dy"] = (
          _cross_time_branch(model, rb, cfg, stage, featmaps[1], out_stage,
                             pts, z_vals, kernels))
  return ret


def render_rays_mono(model, rb: Dict[str, Any], featmaps,
                     cfg: RenderSettings, *, device: DeviceLike = None,
                     kernels: Kernels = True, is_train: bool = False,
                     det: bool = True,
                     generator: Optional[torch.Generator] = None,
                     needs_grad: Optional[bool] = None) -> Dict[str, Any]:
  """Forward of the monocular model for one ray batch (dynibar_tpu
  render_rays.py:135-269, reference render_ray.py:870-1277).

  featmaps: (dynamic [Vd,Hf,Wf,C], anchor [Va,Hf,Wf,C] or None, static
  [Vs,Hf,Wf,C]).  Returns outputs_coarse_ref / _ref_dy / _st and, with
  is_train, outputs_coarse_anchor(_dy) with the occlusion weights,
  matched trajectory pairs and scene-flow sequence the loss reads.
  needs_grad (default is_train) records the render for a backward: the
  sampler is then F.grid_sample and the aggregators their autograd
  Functions; without it the pass runs under no_grad through K1-K3.
  det=False places the samples stochastically from ``generator``."""
  dev = resolve_device(device)
  if model.device != dev:
    raise ValueError(f"model is on {model.device}, render asked for {dev}")
  # render-derived flow against the first 6 (temporal) source views
  return _render_one_stage(
      model, to_device(rb, dev), featmaps, cfg, None, kernels=kernels,
      is_train=is_train, det=det, generator=generator,
      needs_grad=is_train if needs_grad is None else needs_grad,
      flow_views=6, sf_step=1, static_composite=True)


def render_rays_ff_coarse(model, rb: Dict[str, Any], coarse_featmaps,
                          cfg: RenderSettings, *, device: DeviceLike = None,
                          kernels: Kernels = True, is_train: bool = True,
                          det: bool = False,
                          generator: Optional[torch.Generator] = None,
                          needs_grad: Optional[bool] = None
                          ) -> Dict[str, Any]:
  """The forward-facing model's coarse stage on its own, for training the
  frozen coarse stage the fine stage loads (dynibar_tpu
  render_rays.py:527-597; google/dynibar ships that stage only as data,
  model.py:102).  A single-stage render on the coarse nets structured
  like ``render_rays_mono``: uniform samples, the dual composite, flows
  against all 7 sources, s_vals, a detached expected scene flow over 2
  frames and, with is_train, the cross-time branch at the coarse nets.

  coarse_featmaps: (dynamic, anchor or None, static) as
  ``FFModel.encode_coarse_featmaps`` routes them.  Returns the key layout
  ``compute_mono_losses`` reads (outputs_coarse_ref, _ref_dy, _anchor,
  _anchor_dy).  needs_grad (default is_train) as in
  ``render_rays_mono``."""
  dev = resolve_device(device)
  if model.device != dev:
    raise ValueError(f"model is on {model.device}, render asked for {dev}")
  return _render_one_stage(
      model, to_device(rb, dev), coarse_featmaps, cfg, "coarse",
      kernels=kernels, is_train=is_train, det=det, generator=generator,
      needs_grad=is_train if needs_grad is None else needs_grad,
      flow_views=None, sf_step=2, static_composite=False)
