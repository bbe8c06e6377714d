"""Full-frame rendering as a plain chunk loop.

Port of ``dynibar_tpu.render.render_image.full_image_ray_batch``,
``render_image_ff`` and ``render_image_mono`` (reference
ibrnet/render_image.py:9-439).  Feature maps are encoded once per frame by
the caller; chunks run in order on the current stream, without autograd,
and their kept outputs are read back to the host.  The JAX package's
sampling-coverage fallback (``_exact_cfg``) has no counterpart: the CUDA
sampler is exact for every sample.

Under a mesh (``parallel/mesh.py``; ``mesh=``) each rank renders a
contiguous share of the frame's rays (the last share padded with the
frame's last ray) in chunks of ``chunk_size``; rank 0 gathers the shares
and returns the images, the other ranks return None.  A ray's render
depends on no other ray, so the gathered frame is the one-card frame.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.core.cameras import pixel_rays, split_camera
from dynibar_tpu_torch.parallel.mesh import (RAY_SHARDED_AXIS1_KEYS,
                                             RAY_SHARDED_KEYS)
from dynibar_tpu_torch.render.render_rays import (render_rays_mono,
                                                  render_rays_mv)
from dynibar_tpu_torch.utils.device import (DeviceLike, resolve_device,
                                            to_device)

# the per-ray keys (parallel/mesh.py) are cut into chunks; everything else
# is shared by every chunk
_KEEP = ("rgb", "depth", "mask")


def full_image_ray_batch(rb_template: Dict[str, Any], camera,
                         render_stride: int = 1,
                         device: DeviceLike = None) -> Dict[str, Any]:
  """Expand a ray-batch template to every pixel of `camera`
  (reference sample_ray.py:165-235 ``get_all``)."""
  dev = resolve_device(device)
  rb = to_device(rb_template, dev)
  camera = to_device({"c": camera}, dev)["c"]
  h, w, k, c2w = split_camera(camera)
  ray_o, ray_d, uv = pixel_rays(int(h), int(w), k, c2w, stride=render_stride)
  for key in RAY_SHARDED_KEYS + RAY_SHARDED_AXIS1_KEYS:
    rb.pop(key, None)
  # row-major, as a mesh rank's gathered share is: the CPU's kernels round
  # a transposed ray_d otherwise
  rb.update(ray_o=ray_o.contiguous(), ray_d=ray_d.contiguous(), uv_grid=uv,
            camera=camera)
  return rb


def _images(parts: Dict[str, Dict[str, list]], height: int, width: int
            ) -> Dict[str, Dict[str, np.ndarray]]:
  """Concatenated chunk outputs -> [H, W, .] numpy arrays; rgb zeroed where
  the mask says no source view saw the ray (reference
  render_image.py:384-411)."""
  result = {}
  for name, fields in parts.items():
    imgs = {k: torch.cat(v, dim=0).cpu().numpy().reshape(
        (height, width) + tuple(v[0].shape[1:])) for k, v in fields.items()}
    imgs["rgb"] = imgs["rgb"] * (imgs["mask"][..., None] > 0)
    result[name] = imgs
  return result


def _rank_share(rb: Dict[str, Any], mesh) -> Dict[str, Any]:
  """This rank's contiguous share of the frame's rays, every share of one
  length (the last padded with the last ray)."""
  n_rays = rb["ray_o"].shape[0]
  share = -(-n_rays // mesh.world)
  idx = torch.clamp(torch.arange(mesh.rank * share, (mesh.rank + 1) * share,
                                 device=rb["ray_o"].device), max=n_rays - 1)
  return {k: (v[idx] if k in RAY_SHARDED_KEYS else v) for k, v in rb.items()}


def _finish(parts: Dict[str, Dict[str, list]], height: int, width: int,
            n_rays: int, mesh) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
  """The images; under a mesh the ranks' shares gathered to rank 0 (None
  on the others)."""
  if mesh is None:
    return _images(parts, height, width)
  whole: Dict[str, Dict[str, list]] = {}
  for name, fields in parts.items():
    for k, v in fields.items():
      rows = mesh.gather_rows(torch.cat(v, dim=0))
      if rows is not None:
        whole.setdefault(name, {})[k] = [rows[:n_rays]]
  return _images(whole, height, width) if mesh.is_main else None


def _keep_mono(ret, train_view: bool) -> Dict[str, Dict[str, torch.Tensor]]:
  """The fields a mono frame keeps (dynibar_tpu render_image.py:152-174):
  with ``train_view`` also the observability fields of the training
  panels (expected scene flow, rendered flows [R, V, 2], the anchor's
  occlusion-weight map)."""
  keep = {}
  for name in ("outputs_coarse_ref", "outputs_coarse_st"):
    o = ret[name]
    keep[name] = {k: o[k] for k in ("rgb", "depth", "rgb_static", "rgb_dy")
                  if k in o}
    keep[name]["mask"] = o["mask"].float()
  if train_view:
    o = ret["outputs_coarse_ref"]
    keep["outputs_coarse_ref"]["exp_sf"] = o["exp_sf"]
    keep["outputs_coarse_ref"]["render_flows"] = o["render_flows"].transpose(
        0, 1)
    a = ret["outputs_coarse_anchor"]
    keep["outputs_coarse_anchor"] = {
        "rgb": a["rgb"], "depth": a["depth"], "mask": a["mask"].float(),
        "occ_weight_map": a["occ_weight_map"]}
  return keep


def render_image_mono(model, rb: Dict[str, Any], featmaps,
                      cfg: RenderSettings, chunk_size: int, height: int,
                      width: int, det: bool = True, train_view: bool = False,
                      device: DeviceLike = None, mesh=None
                      ) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
  """Render a full target view with the monocular model.

  Returns {'outputs_coarse_ref': {...}, 'outputs_coarse_st': {...}} of
  [H, W, .] numpy arrays (rgb, depth, mask and, for the composite,
  rgb_static and rgb_dy).  ``train_view`` renders the training program,
  cross-time anchor branch included, and adds exp_sf, render_flows
  [H, W, V, 2] and 'outputs_coarse_anchor' (rgb, depth, mask,
  occ_weight_map): the reference's training panels (train.py:576-762).
  Under ``mesh``, None on ranks other than 0."""
  dev = resolve_device(device)
  rb = to_device(rb, dev)
  n_rays = rb["ray_o"].shape[0]
  if mesh is not None:
    rb = _rank_share(rb, mesh)
  parts: Dict[str, Dict[str, list]] = {}
  with torch.no_grad():
    for start in range(0, rb["ray_o"].shape[0], chunk_size):
      chunk = {k: (v[start:start + chunk_size] if k in RAY_SHARDED_KEYS else v)
               for k, v in rb.items()}
      ret = render_rays_mono(model, chunk, featmaps, cfg, device=dev,
                             is_train=train_view, det=det, needs_grad=False)
      for name, fields in _keep_mono(ret, train_view).items():
        for k, v in fields.items():
          parts.setdefault(name, {}).setdefault(k, []).append(v.float())
  return _finish(parts, height, width, n_rays, mesh)


def render_image_ff(model, rb: Dict[str, Any], coarse_featmaps,
                    fine_featmaps, cfg: RenderSettings, chunk_size: int,
                    height: int, width: int,
                    device: DeviceLike = None, kernels: bool = True,
                    mesh=None
                    ) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
  """Render a full target view with the forward-facing model.

  Returns {'outputs_coarse_ref': {...}, 'outputs_fine_ref': {...}} of
  [H, W, ·] numpy arrays (rgb, depth, mask); rgb is zeroed where the mask
  says no source view saw the ray (reference render_image.py:384-411).
  ``kernels=False`` renders through the plain twins (a comparison on the
  card).  Under ``mesh``, None on ranks other than 0."""
  dev = resolve_device(device)
  rb = to_device(rb, dev)
  n_rays = rb["ray_o"].shape[0]
  if mesh is not None:
    rb = _rank_share(rb, mesh)
  parts = {name: {k: [] for k in _KEEP}
           for name in ("outputs_coarse_ref", "outputs_fine_ref")}
  for start in range(0, rb["ray_o"].shape[0], chunk_size):
    chunk = {k: (v[start:start + chunk_size] if k in RAY_SHARDED_KEYS else v)
             for k, v in rb.items()}
    ret = render_rays_mv(model, chunk, coarse_featmaps, fine_featmaps, cfg,
                         device=dev, kernels=kernels)
    for name, fields in parts.items():
      for k in _KEEP:
        fields[k].append(ret[name][k].float())
  return _finish(parts, height, width, n_rays, mesh)
