"""OpenCV's image read and area resize, in numpy, for the eval path.

The Nvidia eval reads its ground truth as ``cv2.imread(path)[:, :, ::-1]``
and shrinks it with ``cv2.resize(..., cv2.INTER_AREA)`` on uint8; the
machine with the card has no OpenCV.  ``imread_color`` gives
``IMREAD_COLOR``'s result in RGB order from ``llff.read_image``: a gray
file becomes three equal channels and an alpha channel is dropped.
``resize_area`` follows OpenCV's two INTER_AREA paths (imgproc
resize.cpp): at whole-number ratios the box average, as
``(sum + 2) >> 2`` at 2x2 and ``sum * (1 / area)`` rounded half to even
at the others; at any other ratio the per-axis area weights
(``computeResizeAreaTab``) summed in f32 in OpenCV's order, rounded half
to even.  The nearest-neighbour resize is ``monocular.resize_nearest``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from dynibar_tpu_torch.data import llff


def imread_color(path: str) -> np.ndarray:
  """``cv2.imread(path)[:, :, ::-1]``: uint8 [H, W, 3] RGB."""
  img = llff.read_image(path)
  if img.ndim == 2:
    img = img[..., None]
  if img.shape[-1] in (1, 2):                  # gray (+ alpha)
    return np.repeat(img[..., :1], 3, axis=-1)
  return np.ascontiguousarray(img[..., :3])


def _area_tab(ssize: int, dsize: int, scale: float
              ) -> List[List[Tuple[int, np.float32]]]:
  """computeResizeAreaTab: for each output index, its (source index,
  weight) terms in OpenCV's order."""
  tab = []
  for dx in range(dsize):
    fsx1 = dx * scale
    fsx2 = fsx1 + scale
    cell = min(scale, ssize - fsx1)
    sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
    sx2 = min(sx2, ssize - 1)
    sx1 = min(sx1, sx2)
    terms = []
    if sx1 - fsx1 > 1e-3:
      terms.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
    for sx in range(sx1, sx2):
      terms.append((sx, np.float32(1.0 / cell)))
    if fsx2 - sx2 > 1e-3:
      terms.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    tab.append(terms)
  return tab


def _weighted(x: np.ndarray, tab, axis: int) -> np.ndarray:
  """sum_k w_k * x[src_k] along `axis`, term by term in f32 (the terms of
  every output index in their own order)."""
  x = np.moveaxis(x, axis, 0)
  out = np.zeros((len(tab),) + x.shape[1:], np.float32)
  for slot in range(max(len(t) for t in tab)):
    rows = [d for d, t in enumerate(tab) if len(t) > slot]
    src = [tab[d][slot][0] for d in rows]
    w = np.array([tab[d][slot][1] for d in rows], np.float32)
    w = w.reshape((-1,) + (1,) * (x.ndim - 1))
    out[rows] = out[rows] + x[src] * w
  return np.moveaxis(out, 0, axis)


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
  """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of a uint8
  [H, W] or [H, W, C] image, for a shrink (or the same size)."""
  sh, sw = img.shape[:2]
  if (sh, sw) == (h, w):
    return img.copy()
  scale_y, scale_x = 1.0 / (h / sh), 1.0 / (w / sw)
  if scale_x < 1 or scale_y < 1:
    raise ValueError(f"resize_area shrinks: {sh}x{sw} -> {h}x{w}")
  iy, ix = int(round(scale_y)), int(round(scale_x))
  eps = np.finfo(np.float64).eps
  if abs(scale_y - iy) < eps and abs(scale_x - ix) < eps:
    # resizeAreaFast: each output pixel sums an iy x ix cell
    cells = img[:h * iy, :w * ix].astype(np.int64)
    cells = cells.reshape((h, iy, w, ix) + img.shape[2:])
    total = cells.sum(axis=(1, 3))
    channels = 1 if img.ndim == 2 else img.shape[2]
    if iy == ix == 2 and channels in (1, 3, 4):
      out = (total + 2) >> 2
    else:
      out = np.rint(total.astype(np.float32) * np.float32(1.0 / (iy * ix)))
    return np.clip(out, 0, 255).astype(np.uint8)
  # resizeArea_: rows weighted per source row, then the rows summed with
  # their own weights, every product and sum in f32
  x = img.astype(np.float32)
  across = _weighted(x, _area_tab(sw, w, scale_x), axis=1)
  out = _weighted(across, _area_tab(sh, h, scale_y), axis=0)
  return np.clip(np.rint(out), 0, 255).astype(np.uint8)
