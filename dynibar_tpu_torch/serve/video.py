"""Video encoding and camera-path generation for the rendering service.

Port of ``dynibar_tpu.serve.video``.  The reference's space-time
rendering (render_monocular_bt.py:297-366) writes loose PNG frames and
leaves video assembly to the user; here a camera path (an explicit pose
list, or one of the reference's named generators) renders frame by frame
through the resident session and comes back as one mp4v payload.

The mp4 writer is OpenCV's, imported only when a caller asks for mp4: a
machine without cv2 renders PNG frames and raises, naming cv2, only on an
mp4 request.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from dynibar_tpu_torch.data.llff import (parse_llff_pose,
                                         render_stabilization_path,
                                         render_wander_path)


def require_cv2():
  """The cv2 module, or an ImportError that names it."""
  try:
    import cv2
  except ImportError as e:
    raise ImportError(
        "mp4 encoding needs OpenCV (the cv2 module), which is not "
        "installed here; render PNG frames instead (video_out \"\")") from e
  return cv2


def encode_mp4(frames: Sequence[np.ndarray], fps: float = 24.0) -> bytes:
  """Encode [H,W,3] float [0,1] frames into an mp4 container.

  Uses cv2's VideoWriter (mp4v fourcc: universally decodable, no ffmpeg
  binary).  VideoWriter only writes to paths, so the bytes round-trip
  through a temporary file.
  """
  cv2 = require_cv2()
  if not len(frames):
    raise ValueError("no frames to encode")
  h, w = frames[0].shape[:2]
  fd, path = tempfile.mkstemp(suffix=".mp4")
  os.close(fd)
  try:
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             float(fps), (w, h))
    if not writer.isOpened():
      raise RuntimeError("cv2.VideoWriter failed to open")
    try:
      for f in frames:
        if f.shape[:2] != (h, w):
          raise ValueError(
              f"inconsistent frame shape {f.shape[:2]} vs {(h, w)}")
        u8 = (np.clip(f, 0.0, 1.0) * 255.0).astype(np.uint8)
        if u8.ndim == 2:
          u8 = np.repeat(u8[:, :, None], 3, axis=2)
        writer.write(u8[:, :, ::-1])  # RGB -> BGR
    finally:
      writer.release()
    with open(path, "rb") as fh:
      return fh.read()
  finally:
    os.unlink(path)


def write_mp4(path: str, frames: Sequence[np.ndarray],
              fps: float = 24.0) -> None:
  with open(path, "wb") as fh:
    fh.write(encode_mp4(frames, fps))


def _llff_pose(c2w: np.ndarray, focal: float, h: int, w: int) -> np.ndarray:
  """Invert data/llff.parse_llff_pose: OpenCV 4x4 c2w -> LLFF 3x5."""
  m = np.array(c2w, np.float64)
  m[:, 1:3] *= -1
  hwf = np.array([[h], [w], [focal]], np.float64)
  return np.concatenate([m[:3, :4], hwf], axis=1)


def named_path(kind: str, data, render_idx: int = -1,
               num_frames: Optional[int] = None, k_size: int = 45
               ) -> Dict[str, List[np.ndarray]]:
  """One of the reference's camera paths over a loaded scene.

  kind: "stabilization" (smoothed video path, one output per video frame,
  reference llff_data_utils.py:453) or "wander" (circular orbit around
  `render_idx`, reference :413).  `data` is a MonocularSceneData.

  Returns {"c2ws": [4x4 OpenCV c2w...], "frame_idxs": [int...]} aligned.
  """
  n = int(data.num_frames)
  probe = data._load_rgb(0)
  h, w = int(probe.shape[0]), int(probe.shape[1])

  def llff_of(i):
    return _llff_pose(data.c2w[i], float(data.intrinsics[i][0, 0]), h, w)

  if kind == "stabilization":
    poses = np.stack([llff_of(i) for i in range(n)])
    path = render_stabilization_path(poses, k_size=min(k_size, n | 1))
    idxs = list(range(len(path)))
  elif kind == "wander":
    idx = int(np.clip(render_idx if render_idx >= 0 else n // 2,
                      3, n - 4))
    path = render_wander_path(llff_of(idx), num_frames=num_frames or 50)
    idxs = [idx] * len(path)
  else:
    raise ValueError(f"unknown path kind {kind!r} "
                     "(expected 'stabilization' or 'wander')")
  c2ws = [parse_llff_pose(p)[1] for p in path]
  return {"c2ws": c2ws, "frame_idxs": idxs}
