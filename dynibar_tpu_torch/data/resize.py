"""OpenCV's image read, area and linear resize, in numpy.

The Nvidia eval reads its ground truth as ``cv2.imread(path)[:, :, ::-1]``
and shrinks it with ``cv2.resize(..., cv2.INTER_AREA)`` on uint8; the
preprocessing CLI resizes video frames with ``INTER_AREA`` (either way)
and disparity maps with ``INTER_LINEAR`` on f32; the machine with the
card has no OpenCV.  ``imread_color`` gives
``IMREAD_COLOR``'s result in RGB order from ``llff.read_image``: a gray
file becomes three equal channels and an alpha channel is dropped.
``resize_area`` follows OpenCV's two INTER_AREA paths (imgproc
resize.cpp): at whole-number ratios the box average, as
``(sum + 2) >> 2`` at 2x2 and ``sum * (1 / area)`` rounded half to even
at the others; at any other ratio the per-axis area weights
(``computeResizeAreaTab``) summed in f32 in OpenCV's order, rounded half
to even.  Where either axis grows, INTER_AREA is OpenCV's linear resize
with area coefficients, in fixed point on uint8 (``_linear_uint8``);
``resize_linear`` is INTER_LINEAR on f32.  The nearest-neighbour resize
is ``monocular.resize_nearest``.
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


def _linear_tab(ssize: int, dsize: int, area: bool):
  """The source index and f32 fraction of each output index (resize.cpp's
  coefficient loop): half-pixel centres for INTER_LINEAR; for INTER_AREA
  ``sx = floor(dx * scale)``, ``fx = (dx + 1) - (sx + 1) / scale`` and
  ``fx <= 0 ? 0 : fx - floor(fx)``."""
  inv = dsize / ssize
  scale = 1.0 / inv
  d = np.arange(dsize, dtype=np.float64)
  if area:
    src = np.floor(d * scale).astype(np.int64)
    frac = ((d + 1) - (src + 1) * inv).astype(np.float32)
    frac = np.where(frac <= 0, np.float32(0), frac - np.floor(frac))
  else:
    pos = ((d + 0.5) * scale - 0.5).astype(np.float32)
    src = np.floor(pos).astype(np.int64)
    frac = pos - src.astype(np.float32)
  return src, frac.astype(np.float32)


def _x_tab(ssize: int, dsize: int, area: bool):
  """Horizontal taps: outside the image both taps fall on the edge pixel
  with the whole weight on it."""
  src, frac = _linear_tab(ssize, dsize, area)
  low, high = src < 0, src >= ssize - 1
  frac = np.where(low | high, np.float32(0), frac)
  src = np.where(low, 0, np.where(high, ssize - 1, src))
  return src, np.minimum(src + 1, ssize - 1), frac


def _y_tab(ssize: int, dsize: int, area: bool):
  """Vertical taps: the rows clamped, the fraction kept."""
  src, frac = _linear_tab(ssize, dsize, area)
  return (np.clip(src, 0, ssize - 1), np.clip(src + 1, 0, ssize - 1), frac)


def _linear_uint8(img: np.ndarray, h: int, w: int) -> np.ndarray:
  """INTER_AREA where an axis grows: the linear resize with area
  coefficients on uint8, in OpenCV's fixed point (coefficients scaled by
  2048; the vertical pass as ``VResizeLinear<uchar>`` computes it)."""
  sh, sw = img.shape[:2]
  x0, x1, fx = _x_tab(sw, w, area=True)
  y0, y1, fy = _y_tab(sh, h, area=True)
  ax1 = np.rint(fx * np.float32(2048)).astype(np.int64)
  ax0 = np.rint((np.float32(1) - fx) * np.float32(2048)).astype(np.int64)
  by1 = np.rint(fy * np.float32(2048)).astype(np.int64)
  by0 = np.rint((np.float32(1) - fy) * np.float32(2048)).astype(np.int64)
  across = (slice(None),) + (None,) * (img.ndim - 2)
  down = across + (None,)
  src = img.astype(np.int64)
  rows = src[:, x0] * ax0[across] + src[:, x1] * ax1[across]   # [sh, w]
  out = (((by0[down] * (rows[y0] >> 4)) >> 16)
         + ((by1[down] * (rows[y1] >> 4)) >> 16) + 2) >> 2
  return np.clip(out, 0, 255).astype(np.uint8)


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
  """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of an
  f32 [H, W] or [H, W, C] map: half-pixel centres, clamped at the
  borders, the horizontal pass before the vertical one, both in f32.
  At an exact 2x shrink OpenCV takes the 2x2 box average instead."""
  img = np.asarray(img, np.float32)
  sh, sw = img.shape[:2]
  if (sh, sw) == (h, w):
    return img.copy()
  if (sh, sw) == (2 * h, 2 * w):
    cells = img.reshape((h, 2, w, 2) + img.shape[2:])
    total = ((cells[:, 0, :, 0] + cells[:, 0, :, 1])
             + (cells[:, 1, :, 0] + cells[:, 1, :, 1]))
    return total * np.float32(0.25)
  x0, x1, fx = _x_tab(sw, w, area=False)
  y0, y1, fy = _y_tab(sh, h, area=False)
  across = (slice(None),) + (None,) * (img.ndim - 2)
  down = across + (None,)
  rows = img[:, x0] * (np.float32(1) - fx)[across] + img[:, x1] * fx[across]
  return rows[y0] * (np.float32(1) - fy)[down] + rows[y1] * fy[down]


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
  """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of a uint8
  [H, W] or [H, W, C] image, a shrink or an enlargement."""
  sh, sw = img.shape[:2]
  if (sh, sw) == (h, w):
    return img.copy()
  scale_y, scale_x = 1.0 / (h / sh), 1.0 / (w / sw)
  if scale_x < 1 or scale_y < 1:
    return _linear_uint8(img, h, w)
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
