"""Synthetic on-disk scene in the reference dataset layout.

Port of ``dynibar_tpu.data.synthetic_scene.write_synthetic_scene``: the
same arrays, with the PNGs written by ``data/png.py`` (8-bit, filter 0).
It writes ``poses_bounds_cvd.npy``, ``images/``, ``images_WxH/``,
``disp/``, ``flow_i{1,2,3}/``, ``dynamic_masks/``, ``static_masks/``,
``source_virtual_views_WxH/`` and ``source_vv_poses.npy``, so the training
CLI runs from disk without downloaded data.  The scene paints the same
image for every camera pose: it drives the data path, not novel-view
quality.  ``write_synthetic_nvidia_scene`` adds the Nvidia benchmark's
ground truth on top, its JPEGs written by ``data/jpeg.py`` (the bytes
imageio writes).  ``ConsistentScene`` is the analytic multi-view
consistent world with exact ground truth at any pose and time, written
in the monocular layout (``write``) or the Nvidia benchmark's 12-camera
rig (``write_nvidia``): the testbed of the FF convergence gate
(``scripts/port_ff_convergence.py``).
"""

from __future__ import annotations

import os

import numpy as np

from dynibar_tpu_torch.data import jpeg, png


def write_synthetic_scene(root: str, scene: str = "synthetic",
                          num_frames: int = 12, height: int = 32,
                          width: int = 48, focal: float = 40.0,
                          seed: int = 0) -> str:
  """Create <root>/<scene>/dense/... ; returns the scene name.  ``seed``
  is accepted for the JAX writer's signature; the scene is analytic."""
  dense = os.path.join(root, scene, "dense")
  for sub in ("images", f"images_{width}x{height}", "disp", "flow_i1",
              "flow_i2", "flow_i3", "dynamic_masks", "static_masks"):
    os.makedirs(os.path.join(dense, sub), exist_ok=True)
  vv_dir = os.path.join(dense, f"source_virtual_views_{width}x{height}")
  os.makedirs(vv_dir, exist_ok=True)

  # a smooth moving blob over textured background gives the losses signal
  yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
  bg = np.stack([0.5 + 0.4 * np.sin(xx / 7.0), 0.5 + 0.4 * np.cos(yy / 5.0),
                 0.5 + 0.4 * np.sin((xx + yy) / 9.0)], axis=-1)

  rows, vv_poses = [], []
  for i in range(num_frames):
    cx = width * (0.3 + 0.4 * i / num_frames)
    cy = height * 0.5
    blob = np.exp(-(((xx - cx) ** 2) + (yy - cy) ** 2) / 20.0)
    img = np.clip(bg + blob[..., None] * np.array([0.5, -0.2, 0.1]), 0, 1)
    img8 = (img * 255).astype(np.uint8)
    png.write(os.path.join(dense, "images", f"{i:05d}.png"), img8)
    png.write(os.path.join(dense, f"images_{width}x{height}",
                                 f"{i:05d}.png"), img8)
    np.save(os.path.join(dense, "disp", f"{i:05d}.npy"),
            (0.1 + 0.2 * blob).astype(np.float32))
    dyn = (blob > 0.2).astype(np.uint8) * 255
    png.write(os.path.join(dense, "dynamic_masks", f"{i}.png"), dyn)
    png.write(os.path.join(dense, "static_masks", f"{i}.png"),
                    255 - dyn)
    for interval in (1, 2, 3):
      for tag, sign in (("fwd", 1.0), ("bwd", -1.0)):
        flow = np.zeros((height, width, 2), np.float32)
        flow[..., 0] = sign * interval * 0.4 * width / num_frames * blob
        np.savez(os.path.join(dense, f"flow_i{interval}",
                              f"{i:05d}_{tag}.npz"),
                 flow=flow, mask=np.ones((height, width), np.float32))

    pose = np.zeros((3, 5))
    pose[:3, :3] = np.eye(3)
    pose[0, 3] = 0.08 * i
    pose[:, 4] = [height, width, focal]
    rows.append(np.concatenate([pose.reshape(-1), [2.0, 12.0]]))

    frame_dir = os.path.join(vv_dir, f"{i:05d}")
    os.makedirs(frame_dir, exist_ok=True)
    frame_vv = []
    for k in range(8):
      png.write(os.path.join(frame_dir, f"{k:02d}.png"), img8)
      vpose = pose[:, :4].copy()
      vpose[1, 3] += 0.02 * k
      frame_vv.append(vpose)
    vv_poses.append(np.stack(frame_vv))

  np.save(os.path.join(dense, "poses_bounds_cvd.npy"), np.stack(rows))
  np.save(os.path.join(dense, "source_vv_poses.npy"),
          np.moveaxis(np.stack(vv_poses), 0, -1).astype(np.float32))
  return scene


def write_synthetic_nvidia_scene(root: str, scene: str = "Balloon1",
                                 num_frames: int = 12, height: int = 32,
                                 width: int = 48, seed: int = 0) -> str:
  """The Nvidia Dynamic Scenes benchmark layout on top of the monocular
  scene: ``mv_images/<idx>/camXX.jpg`` and ``mv_masks/<idx>/camXX.png``
  ground truth for the 12 round-robin viewpoints and ``coarse_masks/``
  (reference eval_nvidia.py:100-169 read paths), so the whole eval
  protocol runs.  Port of the JAX writer of the same name."""
  write_synthetic_scene(root, scene, num_frames=num_frames, height=height,
                        width=width, seed=seed)
  dense = os.path.join(root, scene, "dense")
  os.makedirs(os.path.join(dense, "coarse_masks"), exist_ok=True)
  yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
  for idx in range(num_frames):
    mv_img_dir = os.path.join(dense, "mv_images", f"{idx:05d}")
    mv_mask_dir = os.path.join(dense, "mv_masks", f"{idx:05d}")
    os.makedirs(mv_img_dir, exist_ok=True)
    os.makedirs(mv_mask_dir, exist_ok=True)
    cx = width * (0.3 + 0.4 * idx / num_frames)
    blob = np.exp(-(((xx - cx) ** 2) + (yy - height * 0.5) ** 2) / 20.0)
    dyn = (blob > 0.2).astype(np.uint8) * 255
    png.write(os.path.join(dense, "coarse_masks", f"{idx:05d}.png"),
              255 - dyn)  # 1 = static
    for cam in range(12):
      img = np.clip(0.5 + 0.3 * np.sin((xx + yy + cam + idx) / 9.0), 0, 1)
      img8 = (np.stack([img] * 3, axis=-1) * 255).astype(np.uint8)
      jpeg.write(os.path.join(mv_img_dir, f"cam{cam + 1:02d}.jpg"), img8)
      png.write(os.path.join(mv_mask_dir, f"cam{cam + 1:02d}.png"), dyn)
  return scene


class ConsistentScene:
  """Analytic, multi-view-CONSISTENT dynamic 3D scene with exact ground
  truth for any camera pose and continuous time.

  Port of ``dynibar_tpu.data.synthetic_scene.ConsistentScene``: the same
  arrays and files, PNGs through ``data/png.py`` (the same pixels) and the
  ``mv_images`` JPEGs through ``data/jpeg.py`` (imageio's bytes).  The
  quick `write_synthetic_scene` above paints the same image for every
  camera pose, so it can smoke-test plumbing but cannot measure novel-view
  quality.  This class models a true 3D world — a textured background plane
  (z=z_bg), a static textured rectangle on a mid plane (z=z_mid), and a
  textured disc moving on a near plane (z=z_fg) — rendered through the exact
  pinhole model of core/cameras.py (OpenCV convention: x right, y down,
  z forward; pixel grid with no half-pixel offset, principal point at
  W/2, H/2 like intrinsics_from_hwf).  Everything the reference dataset
  layout needs (images, disparity, ±{1,2,3} optical flow with exact
  occlusion masks, dynamic/static masks, virtual views, poses_bounds) is
  derived from the same world, so training losses are mutually consistent
  and a held-out pose has exact GT — the testbed for convergence runs.

  Disk conventions match the reference preprocessing outputs
  (save_monocular_cameras.py:133-143 pose axis order; train.py:309-313
  motion_mask semantics: the moving object is BLACK in dynamic_masks/ and
  static_masks/ so `1 - img/255` is 1 on the dynamic region).
  """

  Z_FG, Z_MID, Z_BG = 2.5, 4.0, 6.0
  DISC_R = 0.55
  RECT = (-2.4, -0.9, -1.2, 0.3)        # x0, x1, y0, y1 on the mid plane
  BOUNDS = (2.0, 8.0)

  def __init__(self, num_frames: int = 24, height: int = 96,
               width: int = 144, focal: float = 0.0):
    self.num_frames = num_frames
    self.h, self.w = height, width
    self.f = focal or 0.7 * width
    n = num_frames
    xs = np.linspace(-0.8, 0.8, n)
    ys = 0.08 * np.sin(np.linspace(0.0, 4.0 * np.pi, n))
    self.cam_t = np.stack([xs, ys, np.zeros(n)], axis=-1)  # [N, 3]

  # ------------------------------------------------------------ geometry --
  def disc_center(self, tau) -> np.ndarray:
    """Disc center (x, y) on the z=Z_FG plane at continuous frame time."""
    u = np.float64(tau) / max(self.num_frames - 1, 1)
    return np.array([-0.9 + 1.8 * u, 0.45 * np.sin(2.0 * np.pi * u)])

  def c2w(self, i: int) -> np.ndarray:
    """4x4 OpenCV camera-to-world of training frame i (disk units)."""
    m = np.eye(4)
    m[:3, 3] = self.cam_t[i]
    return m

  def _pose_at(self, t_xyz) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = np.asarray(t_xyz, np.float64)
    return m

  def vv_c2w(self, i: int) -> np.ndarray:
    """8 virtual-view cameras around frame i -> [8, 4, 4]."""
    out = []
    for k in range(8):
      dx = 0.12 * ((k % 4) - 1.5) / 1.5
      dy = 0.08 * (1.0 if k >= 4 else -1.0)
      out.append(self._pose_at(self.cam_t[i] + [dx, dy, 0.0]))
    return np.stack(out)

  def held_out_cameras(self):
    """Novel validation poses (never in the training path) as
    [(c2w 4x4, tau frame-time), ...]."""
    mid = self.num_frames // 2
    base = self.cam_t[mid]
    return [
        (self._pose_at(base + [0.06, 0.14, 0.0]), float(mid)),
        (self._pose_at(0.5 * (self.cam_t[mid] + self.cam_t[mid + 1])
                       + [0.0, -0.12, 0.0]), float(mid)),
    ]

  def _rays(self, c2w: np.ndarray):
    """Per-pixel ray origins/dirs; matches core.cameras.pixel_rays."""
    uu, vv = np.meshgrid(np.arange(self.w, dtype=np.float64),
                         np.arange(self.h, dtype=np.float64))
    d = np.stack([(uu - self.w / 2.0) / self.f,
                  (vv - self.h / 2.0) / self.f,
                  np.ones_like(uu)], axis=-1)
    d = d @ c2w[:3, :3].T
    return c2w[:3, 3], d, np.stack([uu, vv], axis=-1)

  def _in_rect(self, p) -> np.ndarray:
    x0, x1, y0, y1 = self.RECT
    return ((p[..., 0] >= x0) & (p[..., 0] <= x1)
            & (p[..., 1] >= y0) & (p[..., 1] <= y1))

  def _surface(self, o, d, tau):
    """First-hit point/label for rays (o [3], d [..., 3]) at time tau.
    Returns (point [..., 3], label [...]) with label 0=bg, 1=rect, 2=disc."""
    def plane(z):
      s = (z - o[2]) / d[..., 2]
      return o + d * s[..., None]
    p_fg, p_mid, p_bg = plane(self.Z_FG), plane(self.Z_MID), plane(self.Z_BG)
    c = self.disc_center(tau)
    hit_fg = ((p_fg[..., 0] - c[0]) ** 2
              + (p_fg[..., 1] - c[1]) ** 2) < self.DISC_R ** 2
    hit_mid = self._in_rect(p_mid)
    label = np.where(hit_fg, 2, np.where(hit_mid, 1, 0)).astype(np.int32)
    point = np.where(hit_fg[..., None], p_fg,
                     np.where(hit_mid[..., None], p_mid, p_bg))
    return point, label

  # ------------------------------------------------------------ textures --
  def _bg_tex(self, p):
    x, y = p[..., 0], p[..., 1]
    return np.clip(np.stack([
        0.5 + 0.30 * np.sin(1.3 * x + 0.7) * np.cos(0.9 * y),
        0.5 + 0.30 * np.sin(0.8 * x - 1.1 * y + 2.0),
        0.5 + 0.30 * np.cos(1.7 * x + 0.6 * y)], axis=-1), 0, 1)

  def _mid_tex(self, p):
    x, y = p[..., 0], p[..., 1]
    return np.clip(np.stack([
        0.35 + 0.25 * np.cos(3.0 * x),
        0.55 + 0.25 * np.sin(3.0 * y + 1.0),
        0.35 + 0.20 * np.sin(2.0 * (x + y))], axis=-1), 0, 1)

  def _fg_tex(self, p, tau):
    c = self.disc_center(tau)
    dx, dy = p[..., 0] - c[0], p[..., 1] - c[1]
    rr = np.sqrt(dx * dx + dy * dy) / self.DISC_R
    ang = np.arctan2(dy, dx)
    return np.clip(np.stack([
        0.75 + 0.20 * np.cos(6.0 * np.pi * rr),
        0.30 + 0.15 * np.sin(3.0 * ang),
        0.25 + 0.20 * (1.0 - rr)], axis=-1), 0, 1)

  # ----------------------------------------------------------- rendering --
  def render(self, c2w: np.ndarray, tau):
    """Exact render -> (rgb [H,W,3] f32, depth [H,W], dyn_mask [H,W] bool).
    depth is camera-frame z (invariant under the loader's recentering)."""
    o, d, _ = self._rays(c2w)
    point, label = self._surface(o, d, tau)
    rgb = self._bg_tex(point)
    rgb = np.where((label == 1)[..., None], self._mid_tex(point), rgb)
    rgb = np.where((label == 2)[..., None], self._fg_tex(point, tau), rgb)
    depth = ((point - o) @ c2w[:3, :3])[..., 2]
    return rgb.astype(np.float32), depth.astype(np.float32), label == 2

  def _visible(self, o, p, label, tau):
    """Is world point p (on surface `label`) visible from origin o at tau?"""
    seg = p - o
    with np.errstate(divide="ignore", invalid="ignore"):
      s_fg = (self.Z_FG - o[2]) / seg[..., 2]
      m = o + seg * s_fg[..., None]
      c = self.disc_center(tau)
      occ_disc = ((s_fg > 1e-6) & (s_fg < 1.0 - 1e-6)
                  & (((m[..., 0] - c[0]) ** 2
                      + (m[..., 1] - c[1]) ** 2) < self.DISC_R ** 2))
      s_mid = (self.Z_MID - o[2]) / seg[..., 2]
      m2 = o + seg * s_mid[..., None]
      occ_rect = ((s_mid > 1e-6) & (s_mid < 1.0 - 1e-6) & self._in_rect(m2))
    occluded = np.where(label == 2, False,
                        occ_disc | ((label == 0) & occ_rect))
    return ~occluded

  def flow_between(self, c2w_i: np.ndarray, c2w_j: np.ndarray,
                   tau_i: float, tau_j: float):
    """Exact optical flow from (camera c2w_i, time tau_i) to (camera c2w_j,
    time tau_j) and its validity mask (out-of-image and occluded-in-target
    pixels masked out).  Cameras may differ — the Nvidia-layout round-robin
    pairs frames from different rig positions."""
    o_i, d, uv = self._rays(c2w_i)
    p, label = self._surface(o_i, d, tau_i)
    shift = self.disc_center(tau_j) - self.disc_center(tau_i)
    p2 = p + np.where((label == 2)[..., None],
                      np.array([shift[0], shift[1], 0.0]), 0.0)
    q = (p2 - c2w_j[:3, 3]) @ c2w_j[:3, :3]
    uv2 = self.f * q[..., :2] / q[..., 2:3] + np.array(
        [self.w / 2.0, self.h / 2.0])
    flow = (uv2 - uv).astype(np.float32)
    inb = ((uv2[..., 0] >= 0) & (uv2[..., 0] <= self.w - 1)
           & (uv2[..., 1] >= 0) & (uv2[..., 1] <= self.h - 1))
    vis = self._visible(c2w_j[:3, 3], p2, label, tau_j)
    return flow, (inb & vis).astype(np.float32)

  def flow(self, i: int, off: int):
    """Exact optical flow frame i -> i+off on the monocular path."""
    j = int(np.clip(i + off, 0, self.num_frames - 1))
    return self.flow_between(self.c2w(i), self.c2w(j), float(i),
                             float(i + off))

  # ---------------------------------------------------------- disk write --
  def _disk_pose_rows(self, c2w: np.ndarray) -> np.ndarray:
    """Invert the loader chain (llff.py:280-283 basis-column swap,
    parse_llff_pose column flip) so load_scene_poses reproduces exactly this
    OpenCV c2w (up to its bd-factor scaling + recentering, both
    rigid/uniform).  Both ops permute/negate COLUMNS; translation (col 3)
    passes through untouched."""
    p = c2w[:3, :4].copy()
    p[:, 1] *= -1.0
    p[:, 2] *= -1.0
    return np.stack([-p[:, 1], p[:, 0], p[:, 2], p[:, 3]], axis=1)

  def _write_frame(self, dense: str, i: int, cam_c2w):
    """Frame i seen by camera ``cam_c2w(i)`` at time i: its image (both
    image folders), disparity, dynamic / static masks (the disc black)
    and exact ±1..3 flows toward the cameras ``cam_c2w`` gives the other
    frames (zeros with a zero mask past the sequence's ends).  Returns
    its poses_bounds row and the static mask (uint8, 255 = static)."""
    c2w_i = cam_c2w(i)
    rgb, depth, dyn = self.render(c2w_i, float(i))
    img8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    png.write(os.path.join(dense, "images", f"{i:05d}.png"), img8)
    png.write(os.path.join(dense, f"images_{self.w}x{self.h}",
                           f"{i:05d}.png"), img8)
    np.save(os.path.join(dense, "disp", f"{i:05d}.npy"),
            (1.0 / depth).astype(np.float32))
    # moving object BLACK (motion_mask = 1 - img/255 is 1 on the disc)
    stat8 = ((~dyn) * 255).astype(np.uint8)
    png.write(os.path.join(dense, "dynamic_masks", f"{i}.png"), stat8)
    png.write(os.path.join(dense, "static_masks", f"{i}.png"), stat8)
    for interval in (1, 2, 3):
      for tag, sign in (("fwd", 1), ("bwd", -1)):
        j = i + sign * interval
        if 0 <= j < self.num_frames:
          fl, fm = self.flow_between(c2w_i, cam_c2w(j), float(i), float(j))
        else:
          fl = np.zeros((self.h, self.w, 2), np.float32)
          fm = np.zeros((self.h, self.w), np.float32)
        np.savez(os.path.join(dense, f"flow_i{interval}",
                              f"{i:05d}_{tag}.npz"), flow=fl, mask=fm)
    hwf = np.array([self.h, self.w, self.f])
    row = np.concatenate(
        [np.concatenate([self._disk_pose_rows(c2w_i), hwf[:, None]],
                        axis=1).reshape(-1),
         np.array(self.BOUNDS, np.float64)])
    return row, stat8

  def write(self, root: str, scene: str = "consistent") -> str:
    dense = os.path.join(root, scene, "dense")
    for sub in ("images", f"images_{self.w}x{self.h}", "disp", "flow_i1",
                "flow_i2", "flow_i3", "dynamic_masks", "static_masks"):
      os.makedirs(os.path.join(dense, sub), exist_ok=True)
    vv_dir = os.path.join(dense, f"source_virtual_views_{self.w}x{self.h}")

    rows, vv_poses = [], []
    for i in range(self.num_frames):
      rows.append(self._write_frame(dense, i, self.c2w)[0])

      frame_dir = os.path.join(vv_dir, f"{i:05d}")
      os.makedirs(frame_dir, exist_ok=True)
      frame_vv = []
      for k, vpose in enumerate(self.vv_c2w(i)):
        vrgb, _, _ = self.render(vpose, float(i))
        png.write(os.path.join(frame_dir, f"{k:02d}.png"),
                  (np.clip(vrgb, 0, 1) * 255).astype(np.uint8))
        frame_vv.append(self._disk_pose_rows(vpose))
      vv_poses.append(np.stack(frame_vv))

    np.save(os.path.join(dense, "poses_bounds_cvd.npy"), np.stack(rows))
    np.save(os.path.join(dense, "source_vv_poses.npy"),
            np.moveaxis(np.stack(vv_poses), 0, -1).astype(np.float32))
    return scene

  # --------------------------------------------------- nvidia rig layout --
  def rig_c2w(self, v: int) -> np.ndarray:
    """Pose of rig camera v (12 fixed cameras, 2 rows x 6 columns — the
    Nvidia Dynamic Scenes capture geometry: a static camera array whose
    cameras take turns over time)."""
    xs = np.linspace(-0.75, 0.75, 6)
    return self._pose_at([xs[v % 6], -0.12 if v < 6 else 0.12, 0.0])

  def frame_c2w(self, i: int) -> np.ndarray:
    """Camera of benchmark frame i: round-robin over the 12 rig cameras
    (reference eval_nvidia.py: frame i is captured by camera i % 12)."""
    return self.rig_c2w(i % 12)

  def write_nvidia(self, root: str, scene: str = "consistent_nvidia") -> str:
    """Write the Nvidia Dynamic Scenes benchmark layout from this world:
    round-robin frames (frame i = rig camera i%12 at time i), LLFF
    poses_bounds_cvd.npy, exact cross-camera flows, coarse_masks (1=static)
    and the mv_images/mv_masks per-frame 12-viewpoint ground truth the eval
    protocol reads (reference eval_nvidia.py:69-169).  Exact GT for ANY
    (viewpoint, time) also comes straight from :meth:`render`, so FF
    convergence runs gate on analytic ground truth."""
    dense = os.path.join(root, scene, "dense")
    for sub in ("images", f"images_{self.w}x{self.h}", "disp", "flow_i1",
                "flow_i2", "flow_i3", "dynamic_masks", "static_masks",
                "coarse_masks"):
      os.makedirs(os.path.join(dense, sub), exist_ok=True)

    rows = []
    for i in range(self.num_frames):
      row, stat8 = self._write_frame(dense, i, self.frame_c2w)
      rows.append(row)
      # 1 = static, read by NvidiaSceneData.coarse_mask/_motion_mask
      png.write(os.path.join(dense, "coarse_masks", f"{i:05d}.png"), stat8)

      mv_img_dir = os.path.join(dense, "mv_images", f"{i:05d}")
      mv_mask_dir = os.path.join(dense, "mv_masks", f"{i:05d}")
      os.makedirs(mv_img_dir, exist_ok=True)
      os.makedirs(mv_mask_dir, exist_ok=True)
      for v in range(12):
        vrgb, _, vdyn = self.render(self.rig_c2w(v), float(i))
        jpeg.write(os.path.join(mv_img_dir, f"cam{v + 1:02d}.jpg"),
                   (np.clip(vrgb, 0, 1) * 255).astype(np.uint8))
        png.write(os.path.join(mv_mask_dir, f"cam{v + 1:02d}.png"),
                  (vdyn * 255).astype(np.uint8))

    np.save(os.path.join(dense, "poses_bounds_cvd.npy"), np.stack(rows))
    return scene
