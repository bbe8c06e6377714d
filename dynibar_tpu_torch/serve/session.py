"""Resident render state: checkpoint + scene + warm feature maps.

Port of ``dynibar_tpu.serve.session``.  The offline CLI
(cli/render_monocular.py, after the reference's render_monocular_bt.py)
re-runs the feature net and re-selects source views for every output
frame.  A serving process amortizes that:

  * the checkpoint is loaded once into a ``MonoModel`` on the session's
    device;
  * per-frame source stacks and their feature maps are computed on first
    use (without autograd) and kept on that device in a small LRU cache (a
    frame's sources depend only on the frame index, not on the requested
    camera);
  * every render runs under the session's lock, with the session's device
    current, on the calling thread's current stream: HTTP handler threads
    queue on the lock (under a mesh, on the mesh's lock first).

The template's random generator is shared across frames, as in the JAX
session: an evicted frame's re-encode draws new virtual views.

Under a mesh (``parallel/mesh.py``; the session builds it from the
config, as the JAX session does) rank 0 serves.  Each of its renders
first broadcasts a header (the scene, the frame index, the camera, the
stride and the frame's virtual views) on the mesh's gloo header group;
every rank then renders its share of the rays and rank 0 assembles the
frame.  The header and the render's collectives run under the mesh's
lock, so two requests, to one scene or two, never interleave theirs.
Ranks above 0 run :func:`follow` until rank 0 sends
:func:`stop_followers`.  A follower whose cached frame has other virtual
views than rank 0's re-encodes it with rank 0's.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from dynibar_tpu_torch.cli.render_monocular import (NO_SCENE,
                                                    render_batch_template)
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.core.cameras import make_camera
from dynibar_tpu_torch.data.monocular import MonocularSceneData
from dynibar_tpu_torch.models.dynibar import MonoModel
from dynibar_tpu_torch.parallel.mesh import Mesh, training_mesh
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_mono)
from dynibar_tpu_torch.utils import checkpoints as ckpt_lib
from dynibar_tpu_torch.utils.device import (DeviceLike, resolve_device,
                                            to_device)


class RenderSession:
  """One scene + one checkpoint, resident on one device.

  Args:
    config: system config (folder_path/train_scenes select the scene).
    state_dict: the MonoModel's weights; if None, loaded from the config's
      checkpoint (the training CLI's newest snapshot, or ckpt_path).
    featmap_cache: number of frames whose source stacks + feature maps stay
      resident (a frame costs ~V x Hf x Wf x C entries).
    device: None means the CUDA card; "cpu" runs the plain twins.
  """

  def __init__(self, config: DynibarConfig,
               state_dict: Optional[Dict[str, torch.Tensor]] = None,
               featmap_cache: int = 8, device: DeviceLike = None):
    if not config.train_scenes:
      raise ValueError(NO_SCENE)
    self.mesh = training_mesh(config, device)
    self.config = config
    self.device = (self.mesh.device if self.mesh is not None
                   else resolve_device(device))
    self.data = MonocularSceneData(config, config.train_scenes[0])
    config.num_frames = self.data.num_frames
    self.cfg = config.render_settings("mono")
    self.model = MonoModel(self.cfg, num_frames=self.data.num_frames,
                           device=self.device)
    self.step = 0
    if state_dict is None:
      payload, self.step = ckpt_lib.resume_from(
          config.out_folder(), config.ckpt_path, map_location=self.device)
      if payload is None:
        raise FileNotFoundError(
            f"no checkpoint under {config.out_folder()!r}")
      state_dict = payload["model"]
    self.model.load_state_dict(state_dict)

    probe = self.data._load_rgb(0)
    self.height, self.width = int(probe.shape[0]), int(probe.shape[1])

    self._lock = threading.Lock()
    self._cache_size = featmap_cache
    self._frames: "collections.OrderedDict[int, Dict[str, Any]]" = (
        collections.OrderedDict())
    self._rng = np.random.RandomState(0)
    self.stats = collections.Counter()
    self.timings: Dict[str, float] = collections.defaultdict(float)

  def _mesh_lock(self):
    """The mesh's lock (one for all the process's sessions), or none."""
    return (self.mesh.lock if self.mesh is not None
            else contextlib.nullcontext())

  def _on_device(self):
    """The session's card as the thread's current device (a handler
    thread starts on card 0)."""
    if self.device.type == "cuda":
      return torch.cuda.device(self.device)
    return contextlib.nullcontext()

  # ----------------------------------------------------------------- frames
  def _frame_state(self, idx: int, vv_ids=None) -> Dict[str, Any]:
    """Source stacks + device feature maps for frame `idx` (LRU-cached);
    ``vv_ids`` (a follower's, from rank 0) re-encodes a cached frame whose
    virtual views differ."""
    state = self._frames.get(idx)
    if state is not None and (vv_ids is None
                              or np.array_equal(state["vv_ids"], vv_ids)):
      self._frames.move_to_end(idx)
      self.stats["featmap_cache_hits"] += 1
      return state
    self.stats["featmap_cache_misses"] += 1
    t0 = time.perf_counter()
    if vv_ids is None:
      vv_ids = self._rng.choice(8, size=self.config.num_vv, replace=False)
    template = render_batch_template(self.data, idx,
                                     self.config.num_source_views,
                                     self.config.num_vv, self._rng,
                                     vv_ids=vv_ids)
    rb = to_device(template, self.device)
    with torch.no_grad():
      featmaps = self.model.encode_featmaps(rb["src_rgbs"],
                                            rb["static_src_rgbs"])
    state = {"template": rb, "featmaps": featmaps,
             "vv_ids": np.asarray(vv_ids, np.int64)}
    self._frames[idx] = state
    while len(self._frames) > self._cache_size:
      self._frames.popitem(last=False)
    self.timings["featmap_s"] += time.perf_counter() - t0
    return state

  # ----------------------------------------------------------------- render
  def render(self, c2w: np.ndarray, frame_idx: int,
             h: Optional[int] = None, w: Optional[int] = None,
             intrinsics: Optional[np.ndarray] = None,
             stride: int = 1, layers: bool = False
             ) -> Dict[str, np.ndarray]:
    """Render one view.

    Args:
      c2w: [4,4] (or [3,4]) camera-to-world pose in the scene's convention.
      frame_idx: video time to render (clamped to the trainable window,
        same as cli/render_monocular.py).
      h/w/intrinsics: target camera; default to the scene's.
      stride: render every `stride`-th pixel (fast previews).
      layers: include the dynamic-only and static-only composites.

    Returns dict with 'rgb' [H,W,3] float32 in [0,1], 'depth' [H,W], and
    optionally 'rgb_dy'/'rgb_st'.
    """
    idx = int(np.clip(frame_idx, 3, self.data.num_frames - 4))
    h = int(h or self.height)
    w = int(w or self.width)
    intr = np.asarray(intrinsics if intrinsics is not None
                      else self.data.intrinsics[idx], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:np.asarray(c2w).shape[0]] = np.asarray(c2w, np.float32)
    camera = make_camera(h, w, intr, pose)
    if self.mesh is not None and not self.mesh.is_main:
      raise RuntimeError("mesh ranks above 0 render through follow()")

    with self._mesh_lock(), self._lock, self._on_device():
      t0 = time.perf_counter()
      state = self._frame_state(idx)
      if self.mesh is not None:
        self.mesh.broadcast_header(_header(
            self.config.train_scenes[0], idx, stride, state["vv_ids"],
            camera))
      out = self._render(state, camera, stride, layers)
      self.stats["renders"] += 1
      self.timings["render_s"] += time.perf_counter() - t0
    return out

  def _render(self, state, camera: np.ndarray, stride: int, layers: bool
              ) -> Optional[Dict[str, np.ndarray]]:
    """One frame from its state (None on mesh ranks other than 0)."""
    h, w = int(camera[0]), int(camera[1])
    rb = full_image_ray_batch(state["template"], camera,
                              render_stride=stride, device=self.device)
    ret = render_image_mono(self.model, rb, state["featmaps"], self.cfg,
                            self.config.chunk_size,
                            (h + stride - 1) // stride,
                            (w + stride - 1) // stride,
                            device=self.device, mesh=self.mesh)
    if ret is None:
      return None
    ref = ret["outputs_coarse_ref"]
    out = {"rgb": ref["rgb"], "depth": ref["depth"]}
    if layers:
      # the dynamic/static decompositions come out of the dual composite
      # (core/composite.py), the static-only render beside it
      out["rgb_dy"] = ref["rgb_dy"]
      out["rgb_st"] = ret["outputs_coarse_st"]["rgb"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}

  def follow_render(self, req: Dict[str, Any]) -> None:
    """A follower's share of the render rank 0 announced in ``req``."""
    with self._lock, self._on_device():
      t0 = time.perf_counter()
      state = self._frame_state(req["frame_idx"], req["vv_ids"])
      self._render(state, req["camera"], req["stride"], layers=False)
      self.stats["renders"] += 1
      self.timings["render_s"] += time.perf_counter() - t0

  def render_path(self, c2ws, frame_idxs, stride: int = 1,
                  layer: str = "rgb") -> "list[np.ndarray]":
    """Render a camera path: aligned pose/frame lists -> list of images.

    Feature maps are LRU-cached per frame, so stabilization paths (one new
    frame per pose) pay one encode per frame and wander paths (one frame,
    many poses) pay one in all.
    """
    if len(c2ws) != len(frame_idxs):
      raise ValueError(f"{len(c2ws)} poses vs {len(frame_idxs)} frame_idxs")
    frames = []
    for c2w, idx in zip(c2ws, frame_idxs):
      out = self.render(np.asarray(c2w, np.float32), int(idx),
                        stride=stride, layers=layer in ("rgb_dy", "rgb_st"))
      if layer not in out:
        raise ValueError(f"unknown layer {layer!r}")
      frames.append(out[layer])
    if layer == "depth":
      # one normalization range for the whole path: per-frame min/max
      # would make the depth video flicker as scene depth shifts
      lo = min(float(f.min()) for f in frames)
      hi = max(float(f.max()) for f in frames)
      frames = [(f - lo) / max(hi - lo, 1e-8) for f in frames]
    return frames

  # ------------------------------------------------------------------- meta
  def meta(self) -> Dict[str, Any]:
    return {
        "scene": self.config.train_scenes[0],
        "num_frames": int(self.data.num_frames),
        "height": self.height,
        "width": self.width,
        "depth_range": [float(x) for x in np.asarray(self.data.depth_range)],
        "checkpoint_step": int(self.step),
        "frame_window": [3, int(self.data.num_frames - 4)],
    }

  def warmup(self, frame_idx: int = 3, stride: int = 8) -> float:
    """Build the kernels and encode a frame; returns elapsed seconds."""
    t0 = time.perf_counter()
    self.render(np.asarray(self.data.c2w[frame_idx]), frame_idx,
                stride=stride)
    return time.perf_counter() - t0


# the render header: op, frame index, stride, the count of virtual views,
# up to 8 of their ids, the 34-float camera, then the scene's name (UTF-8,
# one byte per entry)
_CAMERA_AT, _NAME_AT, HEADER_LEN = 12, 64, 64 + 256


def _header(scene: str, idx: int, stride: int, vv_ids,
            camera: np.ndarray) -> torch.Tensor:
  name = scene.encode()
  vv = np.asarray(vv_ids, np.int64).reshape(-1)
  if len(name) > HEADER_LEN - _NAME_AT or len(vv) > 8:
    raise ValueError(f"scene name {scene!r} or {len(vv)} virtual views do "
                     "not fit the render header")
  h = torch.zeros(HEADER_LEN, dtype=torch.float64)
  h[:4] = torch.tensor([1, idx, stride, len(vv)], dtype=torch.float64)
  h[4:4 + len(vv)] = torch.from_numpy(vv.astype(np.float64))
  h[_CAMERA_AT:_CAMERA_AT + 34] = torch.from_numpy(
      np.asarray(camera, np.float64))
  h[_NAME_AT:_NAME_AT + len(name)] = torch.tensor(list(name),
                                                  dtype=torch.float64)
  return h


def _request(h: torch.Tensor) -> Optional[Dict[str, Any]]:
  """A header's request; None for the stop message."""
  v = h.numpy()
  if v[0] == 0:
    return None
  name = bytes(int(b) for b in v[_NAME_AT:] if b > 0).decode()
  return {"scene": name, "frame_idx": int(v[1]), "stride": int(v[2]),
          "vv_ids": v[4:4 + int(v[3])].astype(np.int64),
          "camera": v[_CAMERA_AT:_CAMERA_AT + 34].astype(np.float32)}


def follow(registry, mesh: Mesh) -> int:
  """The loop of mesh ranks above 0: render the share of every request
  rank 0 broadcasts, in the session of its scene, until the stop message;
  returns the count of renders."""
  n = 0
  while True:
    req = _request(mesh.broadcast_header(
        torch.zeros(HEADER_LEN, dtype=torch.float64)))
    if req is None:
      return n
    registry.get(req["scene"]).follow_render(req)
    n += 1


def stop_followers(mesh: Optional[Mesh]) -> None:
  """Rank 0: end the followers' loops."""
  if mesh is not None and mesh.is_main and mesh.world > 1:
    with mesh.lock:                 # after any render in flight
      mesh.broadcast_header(torch.zeros(HEADER_LEN, dtype=torch.float64))
