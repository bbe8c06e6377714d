"""The data stage of a monocular training step, held against the scene.

Every field of each kept ray batch is worked out again from the scene's
own arrays (``portbench/scenes/mono.py``) and the frozen pose handling
(``portbench/reference/llff.py``), given the draws the pipeline made:
the target frame, the anchor frame, the pixels, the virtual views and
the anchor and static source frames.  Those draws are read back from the
batch (a source frame by its camera, a virtual view by its image) and
checked against the rules they follow: the temporal offsets, the anchor
curriculum of the traffic's epoch, the anchor candidates, the eight
virtual views of a frame, distinct static frames in order.  The
arithmetic below is the data path's own, in the same numpy operations,
so a sound batch matches to the bit: each gap is a largest absolute
difference, and a draw that breaks its rule reads 1.

Frozen from dynibar_tpu_torch/data/monocular.py (``sample_batch``,
``resize_nearest``, ``erode``, ``_disk_kernel``) and
data/ray_batch.py's offsets, commit a749e58.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
from scipy import ndimage

from portbench.reference import llff
from portbench.reference.cameras import make_camera

MONO_SRC_OFFSETS = (1, 2, 3, -1, -2, -3)
ANCHOR_CAND_OFFSETS = (3, 2, 1, 0, -1, -2, -3)
NUM_VV_FILES = 8


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
  sh, sw = img.shape[:2]
  rows = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(int),
                    sh - 1)
  cols = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(int),
                    sw - 1)
  return img[rows][:, cols]


def erode(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
  return ndimage.binary_erosion(mask > 0, structure=kernel.astype(bool),
                                border_value=1).astype(np.float32)


def disk_kernel(radius: int) -> np.ndarray:
  y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
  return (x * x + y * y <= radius * radius).astype(np.uint8)


class MonoBatchReference:
  """What a batch of the scene should hold, field by field."""

  def __init__(self, scene, settings: Dict[str, Any], epoch: int):
    self.scene, self.epoch = scene, epoch
    self.n, self.h, self.w = scene.n, scene.h, scene.w
    self.erosion_radius = int(settings["erosion_radius"])
    self.mask_src_view = bool(settings["mask_src_view"])
    self.init_decay_epoch = int(settings["init_decay_epoch"])
    meta = llff.load_scene_poses(
        scene.poses_bounds(), (self.h, self.w),
        height=int(settings["training_height"]), with_vv=True,
        render_idx=int(settings.get("render_idx", -1)),
        src_vv_poses_file=scene.vv_poses())
    self.scale = meta["scale"]
    self.intrinsics, self.c2w = llff.batch_parse_llff_poses(meta["poses"])
    self.vv_c2w = llff.batch_parse_vv_poses(meta["src_vv_poses"])
    bds = meta["bds"]
    near = float(np.min(bds))
    if np.max(bds) < 10:
      far = min(20.0, float(np.max(bds)) + 15.0)
    else:
      far = min(50.0, max(20.0, float(np.max(bds))))
    self.depth_range = np.array([near * 0.9, far * 1.5], np.float32)
    self.cameras = np.stack([self.camera(i) for i in range(self.n)])

  def camera(self, i: int) -> np.ndarray:
    return make_camera(self.h, self.w, self.intrinsics[i], self.c2w[i])

  def rgb(self, i: int) -> np.ndarray:
    return self.scene.frame8(i)[..., :3].astype(np.float32) / 255.0

  def dyn8(self, i: int) -> np.ndarray:
    return (self.scene.blob(i) > 0.2).astype(np.uint8) * 255

  def masked_src(self, i: int) -> np.ndarray:
    rgb = self.rgb(i)
    if not self.mask_src_view:
      return rgb
    m = self.dyn8(i).astype(np.float32) / 255.0
    return rgb * resize_nearest(m, self.h, self.w)[..., None]

  def vv(self, i: int, k: int):
    img = np.roll(self.scene.frame8(i), shift=(k + 1) * 3, axis=1)
    rgb = img[..., :3].astype(np.float32) / 255.0
    return rgb, make_camera(self.h, self.w, self.intrinsics[i],
                            self.vv_c2w[i, k])

  def motion_mask(self, i: int) -> np.ndarray:
    m = 1.0 - self.dyn8(i).astype(np.float32) / 255.0
    inter = resize_nearest(m, 288, int(round(288.0 * self.w / self.h)))
    eroded = erode((inter > 1e-3).astype(np.float32),
                   disk_kernel(self.erosion_radius))
    return np.float32(resize_nearest(eroded, self.h, self.w))

  def static_mask(self, i: int) -> np.ndarray:
    m = 1.0 - (255 - self.dyn8(i)).astype(np.float32) / 255.0
    return np.float32(resize_nearest(m, self.h, self.w) > 1e-3)

  def frame_of(self, cam: np.ndarray) -> int:
    """The frame whose camera this is, or -1."""
    hit = np.nonzero((self.cameras == cam[None]).all(-1))[0]
    return int(hit[0]) if len(hit) else -1

  def vv_of(self, i: int, rgb: np.ndarray) -> int:
    """Which of frame i's virtual views this image is, or -1."""
    for k in range(NUM_VV_FILES):
      if np.array_equal(self.vv(i, k)[0], rgb):
        return k
    return -1

  def gaps(self, rb: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Each field's largest gap against what the scene says it holds."""
    g: Dict[str, float] = {}

    def put(key, got, want):
      d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
      g[key] = max(g.get(key, 0.0), float(d.max()) if d.size else 0.0)

    def rule(key, ok):
      g[key] = max(g.get(key, 0.0), 0.0 if ok else 1.0)

    idx = int(np.ravel(rb["ref_frame_idx"])[0])
    a = int(np.ravel(rb["anchor_frame_idx"])[0])
    rule("frames", 3 <= idx < self.n - 3)
    max_step = min(3, self.epoch // self.init_decay_epoch + 1)
    rule("anchor_frame", 1 <= abs(a - idx) <= max_step)
    uv = rb["uv_grid"]
    px, py = uv[:, 0].astype(np.int64), uv[:, 1].astype(np.int64)
    rule("pixels", np.array_equal(uv, np.stack([px, py], -1)
                                  .astype(np.float32))
         and len(np.unique(py * self.w + px)) == len(px))
    sel = py * self.w + px

    put("rgb", rb["rgb"], self.rgb(idx).reshape(-1, 3)[sel])
    kinv = np.linalg.inv(self.intrinsics[idx][:3, :3])
    pix = np.concatenate([uv, np.ones_like(uv[:, :1])], axis=-1)
    ray_d = (self.c2w[idx][:3, :3] @ (kinv @ pix.T)).T.astype(np.float32)
    put("ray_d", rb["ray_d"], ray_d)
    put("ray_o", rb["ray_o"], np.broadcast_to(self.c2w[idx][:3, 3],
                                              ray_d.shape).astype(np.float32))
    put("depth_range", rb["depth_range"], self.depth_range)
    put("camera", rb["camera"], self.camera(idx))
    put("times", np.concatenate([np.ravel(rb["ref_time"]),
                                 np.ravel(rb["anchor_time"])]),
        [np.float32(idx / self.n), np.float32(a / self.n)])
    disp = np.float32(0.1 + 0.2 * self.scene.blob(idx)) / self.scale
    put("disp", rb["disp"], disp.reshape(-1)[sel].astype(np.float32))
    put("motion_mask", rb["motion_mask"],
        self.motion_mask(idx).reshape(-1)[sel])
    put("static_mask", rb["static_mask"],
        self.static_mask(idx).reshape(-1)[sel])
    for j, o in enumerate(MONO_SRC_OFFSETS):
      flow = self.scene.flow(idx, abs(o), 1.0 if o > 0 else -1.0)
      put("flows", rb["flows"][j], flow.reshape(-1, 2)[sel])
    put("flow_masks", rb["flow_masks"], np.ones_like(rb["flow_masks"]))

    # dynamic sources: the temporal frames, then virtual views of idx
    n_t = len(MONO_SRC_OFFSETS)
    for j, o in enumerate(MONO_SRC_OFFSETS):
      put("src_rgbs", rb["src_rgbs"][j], self.rgb(idx + o))
      put("src_cameras", rb["src_cameras"][j], self.camera(idx + o))
    vv_src = [self.vv_of(idx, rb["src_rgbs"][j])
              for j in range(n_t, len(rb["src_rgbs"]))]
    rule("src_vv", -1 not in vv_src and len(set(vv_src)) == len(vv_src))
    for j, k in enumerate(vv_src):
      if k >= 0:
        put("src_cameras", rb["src_cameras"][n_t + j], self.vv(idx, k)[1])
    put("src_offset_idx", rb["src_offset_idx"],
        [o + 3 for o in MONO_SRC_OFFSETS] + [3] * len(vv_src))
    put("src_valid", rb["src_valid"], np.ones(len(rb["src_valid"])))

    # anchor sources: the candidates around the anchor frame, then its
    # virtual views, then empty slots
    is_vv, valid = rb["anchor_is_vv"], rb["anchor_valid"]
    temporal = [j for j in range(len(valid)) if valid[j] and not is_vv[j]]
    ids = [self.frame_of(rb["anchor_src_cameras"][j]) for j in temporal]
    cands = [a + o for o in ANCHOR_CAND_OFFSETS
             if 0 <= a + o < self.n and a + o != idx]
    rule("anchor_ids", ids in (sorted(cands), sorted(cands + [idx])))
    want_off = []
    for j, i in zip(temporal, ids):
      put("anchor_src_rgbs", rb["anchor_src_rgbs"][j], self.rgb(i))
      want_off.append(int(np.clip(i - a + 3, 0, 6)))
    vv_slots = [j for j in range(len(valid)) if valid[j] and is_vv[j]]
    vv_a = [self.vv_of(a, rb["anchor_src_rgbs"][j]) for j in vv_slots]
    rule("anchor_vv", -1 not in vv_a and len(set(vv_a)) == len(vv_a)
         and temporal + vv_slots == list(range(len(temporal) + len(vv_a))))
    for j, k in zip(vv_slots, vv_a):
      if k >= 0:
        put("anchor_src_cameras", rb["anchor_src_cameras"][j],
            self.vv(a, k)[1])
    pad = list(range(len(temporal) + len(vv_slots), len(valid)))
    for j in pad:
      put("anchor_src_rgbs", rb["anchor_src_rgbs"][j], 0.0)
      put("anchor_src_cameras", rb["anchor_src_cameras"][j],
          rb["anchor_src_cameras"][0])
    put("anchor_offset_idx", rb["anchor_offset_idx"],
        want_off + [3] * (len(vv_slots) + len(pad)))
    put("anchor_valid", valid, [1.0] * (len(temporal) + len(vv_slots))
        + [0.0] * len(pad))

    # static sources: distinct frames of the video, masked, then empty
    st_valid = rb["static_valid"]
    st = [self.frame_of(rb["static_src_cameras"][j])
          for j in range(len(st_valid)) if st_valid[j]]
    rule("static_ids", -1 not in st and st == sorted(set(st))
         and list(st_valid[:len(st)]) == [1.0] * len(st))
    for j, i in enumerate(st):
      if i >= 0:
        put("static_src_rgbs", rb["static_src_rgbs"][j], self.masked_src(i))
    for j in range(len(st), len(st_valid)):
      put("static_src_rgbs", rb["static_src_rgbs"][j], 0.0)
      put("static_src_cameras", rb["static_src_cameras"][j],
          rb["static_src_cameras"][0])
    return g


def mono_batch_gaps(batches, scene, settings: Dict[str, Any], epoch: int
                    ) -> Dict[str, float]:
  """Each field's largest gap over the kept batches."""
  ref = MonoBatchReference(scene, settings, epoch)
  out: Dict[str, float] = {}
  for rb in batches:
    for k, v in ref.gaps({key: t.numpy() for key, t in rb.items()}).items():
      out[k] = max(out.get(k, 0.0), v)
  return out
