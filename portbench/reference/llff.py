"""Frozen copy of the pose handling of dynibar_tpu_torch/data/llff.py at
commit a749e58, part of the benchmark's plain reference
(portbench/reference/__init__.py): pose parsing, recentering and
``load_scene_poses`` with the file reads replaced by arrays the
benchmark holds in memory.  No image IO.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np




def _normalize(x):
  return x / np.linalg.norm(x)


def parse_llff_pose(pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """LLFF 3x5 pose -> (4x4 intrinsics, 4x4 c2w in OpenCV convention)."""
  h, w, f = pose[:3, -1]
  c2w = np.eye(4)
  c2w[:3] = pose[:3, :4]
  c2w[:, 1:3] *= -1
  intrinsics = np.array(
      [[f, 0, w / 2.0, 0], [0, f, h / 2.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
  return intrinsics, c2w


def batch_parse_llff_poses(poses: np.ndarray):
  pairs = [parse_llff_pose(p) for p in poses]
  return (np.stack([p[0] for p in pairs]).astype(np.float32),
          np.stack([p[1] for p in pairs]).astype(np.float32))


def batch_parse_vv_poses(poses: np.ndarray) -> np.ndarray:
  """[N, M, 3, 5] virtual-view LLFF poses -> [N, M, 4, 4] c2w."""
  out = np.stack([
      np.stack([parse_llff_pose(p)[1] for p in per_frame])
      for per_frame in poses])
  return out.astype(np.float32)



def viewmatrix(z, up, pos):
  """Orthonormal c2w frame [right, up', forward, pos] as columns [3, 4]."""
  forward = _normalize(z)
  right = _normalize(np.cross(up, forward))
  true_up = _normalize(np.cross(forward, right))
  return np.stack([right, true_up, forward, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
  """Mean camera of a pose stack [N, 3, 5] -> [3, 5] (with hwf column):
  mean position, summed forward/up directions re-orthonormalized."""
  hwf = poses[0, :3, -1:]
  center = poses[:, :3, 3].mean(0)
  forward = poses[:, :3, 2].sum(0)
  up = poses[:, :3, 1].sum(0)
  return np.concatenate([viewmatrix(forward, up, center), hwf], 1)


def _world_to_avg(poses: np.ndarray) -> np.ndarray:
  """Inverse of the average camera as a full 4x4."""
  c2w_avg = np.eye(4)
  c2w_avg[:3, :4] = poses_avg(poses)[:3, :4]
  return np.linalg.inv(c2w_avg)


def _to_avg_frame(w2avg: np.ndarray, poses34: np.ndarray) -> np.ndarray:
  """Apply a 4x4 world->avg transform to a batch of [..., 3, 4] poses
  (one einsum instead of per-pose bottom-row padding + inv-multiply)."""
  out = np.einsum("ij,...jk->...ik", w2avg[:3, :3], poses34)
  out[..., :, 3] += w2avg[:3, 3]
  return out


def recenter_poses(poses: np.ndarray) -> np.ndarray:
  """Express all poses [N, 3, 5] relative to their average camera."""
  out = poses.copy()
  out[:, :3, :4] = _to_avg_frame(_world_to_avg(poses), poses[:, :3, :4])
  return out


def recenter_poses_mono(poses: np.ndarray, src_vv_poses: np.ndarray):
  """Recenter video poses [N, 3, 5] and virtual-view poses [N, V, 3, 4]
  jointly in the video's average frame (reference llff_data_utils.py:188-213,
  with the per-virtual-view python loop batched away).

  Returns (poses' [N, 3, 5], vv' [N, V, 3, 5] with the hwf column).
  """
  w2avg = _world_to_avg(poses)
  out = poses.copy()
  out[:, :3, :4] = _to_avg_frame(w2avg, poses[:, :3, :4])

  vv = _to_avg_frame(w2avg, src_vv_poses[:, :, :3, :4])     # [N, V, 3, 4]
  hwf = np.broadcast_to(poses[:, None, :, 4:5],
                        vv.shape[:2] + (3, 1))
  return out, np.concatenate([vv, hwf], axis=-1)


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, n):
  """Spiral eval-render path around an anchor camera [3, 5].

  Standard LLFF spiral: camera centers trace an ellipse (radii `rads`) with
  a z oscillation at `zrate`, every view looking at a point `focal` in
  front of the anchor.  `zdelta` is accepted for signature parity with the
  LLFF original but (as there) unused.
  """
  del zdelta
  hwf = c2w[:, 4:5]
  rads4 = np.append(np.asarray(rads, np.float64), 1.0)
  thetas = np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]
  offsets = np.stack([np.cos(thetas), -np.sin(thetas),
                      -np.sin(thetas * zrate), np.ones_like(thetas)],
                     axis=-1) * rads4                        # [n, 4]
  centers = offsets @ c2w[:3, :4].T                          # [n, 3]
  look_at = c2w[:3, :4] @ np.array([0, 0, -focal, 1.0])
  return [np.concatenate([viewmatrix(c - look_at, up, c), hwf], 1)
          for c in centers]


def render_wander_path(c2w: np.ndarray, num_frames: int = 50,
                       max_disp: float = 48.0) -> List[np.ndarray]:
  """Circular in-place camera path around one frame (reference :413-450)."""
  hwf = c2w[:, 4:5]
  max_trans = max_disp / hwf[2][0]
  out = []
  for i in range(num_frames):
    x_t = max_trans * np.sin(2.0 * np.pi * i / num_frames)
    z_t = max_trans * np.cos(2.0 * np.pi * i / num_frames) / 2.0
    i_pose = np.eye(4)
    i_pose[:3, 3] = [x_t, 0.0, z_t]
    i_pose = np.linalg.inv(i_pose)
    ref = np.concatenate([c2w[:3, :4], np.array([[0, 0, 0, 1.0]])], 0)
    render_pose = ref @ i_pose
    out.append(np.concatenate([render_pose[:3, :], hwf], 1))
  return out


def render_vv_wander_paths(c2w: np.ndarray, bd_scale: float,
                           num_samples: int = 4) -> np.ndarray:
  """Virtual-source-view camera poses for one frame.

  The reference's VV preprocessor (render_source_vv.py:68-116,213-236)
  walks TWO in-place wander cycles around the frame's camera — one
  translating in (y, z) with amplitude 56*1.5*bd_scale/f, one in
  (0.5x, y) with 48*1.5*bd_scale/f — and keeps ``num_samples`` poses from
  each at fixed strided phases (cycle indices [5::15] and [15::15] of a
  60-step cycle, the second wrapping through index 60 == 0).

  c2w: [3, 5] LLFF pose row (with hwf column).  Returns
  [2*num_samples, 3, 4] LLFF poses.
  """
  hwf = c2w[:, 4:5]
  f = hwf[2, 0]
  r = c2w[:3, :3]
  t = c2w[:3, 3]

  def variant(amp: float, xyz, first: int) -> np.ndarray:
    n = 60
    idx = (first + (n // num_samples) * np.arange(num_samples)) % n
    ang = 2.0 * np.pi * idx / n
    max_trans = amp * bd_scale / f
    trans = max_trans * np.stack(
        [np.cos(ang) * xyz[0], np.sin(ang) * xyz[1], np.cos(ang) * xyz[2]],
        axis=-1)                                             # [S, 3]
    # render_pose = ref_pose @ inv([I | trans]) -> rotation unchanged,
    # translation t - R @ trans
    ts = t[None, :] - trans @ r.T                            # [S, 3]
    return np.concatenate(
        [np.broadcast_to(r, (num_samples, 3, 3)), ts[:, :, None]], axis=2)

  v0 = variant(56 * 1.5, (0.0, 1.0, 1.0), first=5)
  v1 = variant(48 * 1.5, (0.5, 1.0, 0.0), first=15)
  return np.concatenate([v0, v1], axis=0)


def render_stabilization_path(poses: np.ndarray, k_size: int
                              ) -> List[np.ndarray]:
  """Gaussian-smoothed camera path (reference :453-497), cv2-free.

  Replicates cv2.getGaussianKernel(k, sigma=-1) + filter2D with BORDER_REFLECT_101.
  """
  hwf = poses[0, :, 4:5]
  num_frames = poses.shape[0]
  rows = np.stack([np.concatenate(
      [poses[i, :3, 0:1], poses[i, :3, 1:2], poses[i, :3, 3:4]], axis=-1)
      for i in range(num_frames)])                           # [N, 3, 3]

  sigma = 0.3 * ((k_size - 1) * 0.5 - 1) + 0.8
  xs = np.arange(k_size) - (k_size - 1) / 2.0
  kernel = np.exp(-(xs ** 2) / (2 * sigma ** 2))
  kernel /= kernel.sum()

  def smooth(signal):  # [N, 3] column signal
    padded = np.pad(signal, ((k_size // 2, k_size // 2), (0, 0)),
                    mode="reflect")
    return np.stack([np.convolve(padded[:, c], kernel, mode="valid")
                     for c in range(signal.shape[1])], axis=-1)

  r1 = smooth(rows[:, :, 0])
  r2 = smooth(rows[:, :, 1])
  t = smooth(rows[:, :, 2])
  r1 = r1 / np.linalg.norm(r1, axis=-1, keepdims=True)
  r2 = r2 / np.linalg.norm(r2, axis=-1, keepdims=True)

  out = []
  for i in range(num_frames):
    r3 = np.cross(r1[i], r2[i])
    pose = np.concatenate(
        [r1[i][:, None], r2[i][:, None], r3[:, None], t[i][:, None]], axis=-1)
    out.append(np.concatenate([pose[:3, :], hwf], 1))
  return out


def load_scene_poses(
    poses_bounds: np.ndarray,
    image_shape,
    height: int = 288,
    bd_factor: float = 0.75,
    recenter: bool = True,
    with_vv: bool = False,
    render_idx: int = -1,
    num_avg_imgs: Optional[int] = None,
    src_vv_poses_file: Optional[np.ndarray] = None,
):
  """Shared loading path of load_llff_data / load_mono_data (no image IO).

  Returns dict with poses [N,3,5], bds [2,N], scale, imgfiles, render_poses,
  and (mono) src_vv_poses.
  """
  # the files' reads, from memory: poses_bounds_cvd.npy's array and the
  # frames' (height, width) at the training height
  arr = np.asarray(poses_bounds, np.float64)
  poses = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
  bds = arr[:, -2:].transpose([1, 0])
  sh = tuple(image_shape)
  poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])

  # axis swap: LLFF [down, right, back] -> [right, up, back] style
  poses = np.concatenate(
      [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
  poses = np.moveaxis(poses, -1, 0).astype(np.float32)
  bds = np.moveaxis(bds, -1, 0).astype(np.float32)

  scale = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
  poses[:, :3, 3] *= scale
  bds = bds * scale

  src_vv_poses = None
  if with_vv:
    # file layout: [num_vv, 3, 4, num_frames] 3x4 c2w (no hwf column),
    # written by the virtual-view preprocessor
    # (reference render_source_vv.py:237-240)
    vv = np.asarray(src_vv_poses_file, np.float64)
    # same LLFF->world column swap as the video poses
    vv = np.concatenate(
        [vv[:, :, 1:2, :], -vv[:, :, 0:1, :], vv[:, :, 2:, :]], 2)
    vv = np.moveaxis(vv, -1, 0).astype(np.float32)   # [N, num_vv, 3, 4]
    vv[..., :3, 3] *= scale
    if recenter:
      poses, src_vv_poses = recenter_poses_mono(poses, vv)
    else:
      # append hwf so downstream always sees 3x5 LLFF poses
      hwf = np.broadcast_to(poses[:, None, :, 4:5],
                            vv.shape[:2] + (3, 1))
      src_vv_poses = np.concatenate([vv, hwf], axis=-1)
  elif recenter:
    poses = recenter_poses(poses)

  # render path
  if with_vv:
    if render_idx >= 0:
      render_poses = render_wander_path(poses[render_idx])
    else:
      render_poses = render_stabilization_path(poses, k_size=45)
  else:
    c2w = poses_avg(poses[: (num_avg_imgs or len(poses))])
    up = _normalize(poses[:, :3, 1].sum(0))
    close, inf = bds.min() * 0.9, bds.max() * 2.0
    dt = 0.75
    focal = 1.5 / ((1.0 - dt) / close + dt / inf)
    zdelta = close * 0.2
    rads = np.percentile(np.abs(poses[:, :3, 3]), 80, 0)
    render_poses = render_path_spiral(
        c2w, up, rads, focal, zdelta, zrate=0.5, rots=2, n=120)

  return {
      "poses": poses,
      "bds": bds,
      "scale": scale,
      "render_poses": np.array(render_poses).astype(np.float32),
      "src_vv_poses": src_vv_poses,
  }
