"""The FF eval render core: frozen coarse -> importance -> fine.

Port of ``dynibar_tpu.render.render_rays.render_rays_mv`` and
``_render_stage_ff`` (reference render_ray.py:407-867), eval only.  Each
stage samples the source views through K1 (ops/sample.py) and aggregates
through K2/K3 (ops/agg.py); ``kernels=False`` runs the plain twins
instead, which is how the kernels are held against them on the card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.core import composite as comp
from dynibar_tpu_torch.core import motion
from dynibar_tpu_torch.core import projection as proj
from dynibar_tpu_torch.core import sampling
from dynibar_tpu_torch.ops.sample import sample_views, sample_views_plain
from dynibar_tpu_torch.utils.device import (DeviceLike, resolve_device,
                                            to_device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
  return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                         min=1e-12)


def _sampling_cast(cfg: RenderSettings, imgs, feats):
  """bf16 mode samples images and features in bf16 (half the bytes);
  projection and masks stay f32."""
  if cfg.compute_dtype == "bfloat16":
    return imgs.to(torch.bfloat16), feats.to(torch.bfloat16)
  return imgs, feats


def _motion_window(model, stage, pts, time_emb, frame_idx, window):
  """MotionMLP -> tail-zeroed coeffs -> trajectory points [R,S,O,3]."""
  raw_coeff = model.apply_motion(stage, torch.cat([pts, time_emb], dim=-1))
  raw_coeff = motion.zero_tail_coeffs(raw_coeff, pts.shape[1])
  basis_win = motion.basis_window(model.basis(stage), frame_idx, window)
  return motion.traj_points_window(raw_coeff, basis_win)


def stage_inputs(model, rb, featmaps, cfg: RenderSettings, stage: str,
                 pts, kernels: bool = True) -> Dict[str, Any]:
  """Everything one stage hands its aggregators: trajectories, displaced
  points, sampled features (through K1 unless kernels=False), masks and
  encodings (reference fine_render_rays, render_ray.py:407-597)."""
  w = cfg.traj_window
  n_rays, s = pts.shape[:2]
  time_emb = rb["ref_time"].reshape(1, 1, 1).expand(n_rays, s, 1)
  traj = _motion_window(model, stage, pts, time_emb, rb["ref_frame_idx"], w)
  pts_seq = motion.displaced_points(pts, traj, rb["src_offset_idx"], w)
  pts_static = pts[None].expand((cfg.num_views_static,) + pts.shape)
  sample_fn = sample_views if kernels else sample_views_plain

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


def _render_stage_ff(model, rb, featmaps, cfg: RenderSettings, stage: str,
                     pts, z_vals, kernels: bool):
  """Shared coarse/fine forward: stage inputs -> K3/K2 -> composite."""
  ins = stage_inputs(model, rb, featmaps, cfg, stage, pts, kernels)
  mask, mask_st = ins["dy"][3], ins["st"][5]
  pixel_mask = torch.sum(mask[..., 0].float(), dim=2) > 1
  pixel_mask_st = torch.sum(mask_st[..., 0].float(), dim=2) > 1
  raw_dy = model.apply_dy(stage, *ins["dy"], kernels=kernels)
  raw_st = model.apply_st(stage, *ins["st"], kernels=kernels)
  outputs = comp.composite_dual(raw_dy, raw_st, z_vals, pixel_mask,
                                pixel_mask_st)
  outputs_dy = comp.composite_single(raw_dy, z_vals, pixel_mask)
  return outputs, outputs_dy, ins["traj"], ins["pts_seq"]


@torch.no_grad()
def render_rays_mv(model, rb: Dict[str, Any], coarse_featmaps,
                   fine_featmaps, cfg: RenderSettings, *,
                   device: DeviceLike = None, kernels: bool = True
                   ) -> Dict[str, Any]:
  """Coarse->fine forward of the forward-facing model for one ray chunk
  (reference render_rays_mv, render_ray.py:600-867), eval only: the
  deterministic sample placement (det=True) of the eval render.

  rb: ray-batch dict (numpy or tensors, see data/ray_batch.py);
  featmaps: (dynamic, None, static) per stage, [V, Hf, Wf, C].
  """
  dev = resolve_device(device)
  if model.device != dev:
    raise ValueError(f"model is on {model.device}, render asked for {dev}")
  rb = to_device(rb, dev)
  pts, z_vals, _ = sampling.sample_along_ray(
      rb["ray_o"], rb["ray_d"], rb["depth_range"], cfg.n_samples,
      inv_uniform=cfg.inv_uniform, det=True)
  outputs_coarse, _, _, _ = _render_stage_ff(
      model, rb, coarse_featmaps, cfg, "coarse", pts, z_vals, kernels)

  z_all = sampling.importance_resample_z(
      z_vals, outputs_coarse["weights"], cfg.n_importance,
      inv_uniform=cfg.inv_uniform, det=True)
  near, far = rb["depth_range"][0], rb["depth_range"][1]
  pts_fine = z_all[..., None] * rb["ray_d"][:, None, :] + rb["ray_o"][:, None]
  outputs_fine, outputs_fine_dy, traj_fine, pts_seq_fine = _render_stage_ff(
      model, rb, fine_featmaps, cfg, "fine", pts_fine, z_all, kernels)

  outputs_fine["render_flows"] = comp.render_optical_flow(
      outputs_fine["weights"], pts_seq_fine, rb["src_cameras"],
      rb["uv_grid"])
  outputs_fine["s_vals"] = sampling.z_to_s(z_all, near, far)
  outputs_fine["exp_sf"] = motion.expected_scene_flow(
      outputs_fine["weights"], traj_fine, 2, cfg.traj_window)
  return {
      "outputs_coarse_ref": outputs_coarse,
      "outputs_fine_ref": outputs_fine,
      "outputs_fine_ref_dy": outputs_fine_dy,
  }
