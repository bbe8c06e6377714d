"""Source-view selection (host-side numpy), a copy of
``dynibar_tpu.data.view_selection``.

Parity with reference ibrnet/data_loaders/data_utils.py:85-165
(``get_nearest_pose_ids`` / ``get_interval_pose_ids``) plus the monocular
dataset's randomized-interval static-view picker (monocular.py:276-298).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

TINY = 1e-6


def _angular_dist_vectors(v1, v2):
  u1 = v1 / (np.linalg.norm(v1, axis=1, keepdims=True) + TINY)
  u2 = v2 / (np.linalg.norm(v2, axis=1, keepdims=True) + TINY)
  return np.arccos(np.clip(np.sum(u1 * u2, axis=-1), -1.0, 1.0))


def _angular_dist_matrices(r1, r2):
  tr = np.trace(np.matmul(r2.transpose(0, 2, 1), r1), axis1=1, axis2=2)
  return np.arccos(np.clip((tr - 1) / 2.0, -1 + TINY, 1 - TINY))


def _pose_dists(tar_pose, ref_poses, method, scene_center):
  num = len(ref_poses)
  batched = np.broadcast_to(tar_pose, (num,) + tar_pose.shape)
  if method == "matrix":
    return _angular_dist_matrices(batched[:, :3, :3], ref_poses[:, :3, :3])
  if method == "vector":
    center = np.asarray(scene_center)[None]
    return _angular_dist_vectors(batched[:, :3, 3] - center,
                                 ref_poses[:, :3, 3] - center)
  if method == "dist":
    return np.linalg.norm(batched[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
  raise NotImplementedError(method)


def get_nearest_pose_ids(tar_pose, ref_poses, tar_id=-1,
                         angular_dist_method="vector",
                         scene_center=(0, 0, 0)) -> np.ndarray:
  dists = _pose_dists(tar_pose, ref_poses, angular_dist_method, scene_center)
  if tar_id >= 0:
    dists = dists.copy()
    dists[tar_id] = 1e3
  return np.argsort(dists)


def get_interval_pose_ids(tar_pose, ref_poses, tar_id=-1,
                          angular_dist_method="dist", interval=2,
                          scene_center=(0, 0, 0)) -> np.ndarray:
  original = np.arange(len(ref_poses))
  sub_poses = ref_poses[::interval]
  sub_idx = original[::interval]
  dists = _pose_dists(tar_pose, sub_poses, angular_dist_method, scene_center)
  if tar_id >= 0:
    # exclude the target frame if it survived the subsampling (tar_id is an
    # index in the *original* sequence)
    dists = dists.copy()
    dists[sub_idx == tar_id] = 1e3
  return sub_idx[np.argsort(dists)]


def mono_static_pose_ids(idx: int, num_frames: int, num_frames_sample: int,
                         max_range: int, render_pose, train_poses,
                         rng: np.random.RandomState) -> np.ndarray:
  """Randomized-interval static view selection (monocular.py:276-298).

  Divergence: when ``max_range // num_frames_sample <= 1`` (short scenes /
  small max_range) the reference's ``np.random.randint(2, max_interval+1)``
  raises ``low >= high``; its shipped configs (max_range 40-42, 7 views)
  never hit that edge.  Here the interval floors at 2 instead, keeping
  byte-identical behavior wherever the reference is well-defined.
  """
  max_interval = max_range // num_frames_sample
  lo = max(2, max_interval - 2)
  interval = rng.randint(lo, max(max_interval + 1, lo + 1))
  ids = []
  for ii in range(-num_frames_sample, num_frames_sample):
    rand_j = rng.randint(1, interval + 1)
    sid = idx + interval * ii + rand_j
    if 0 <= sid < num_frames and sid != idx:
      ids.append(sid)
  chosen = set(ids)
  sp = get_nearest_pose_ids(render_pose, train_poses, tar_id=idx,
                            angular_dist_method="dist")
  for sid in sp[::5]:
    if len(ids) >= num_frames_sample * 2:
      break
    if sid not in chosen:
      ids.append(int(sid))
  return np.sort(np.array(ids))
