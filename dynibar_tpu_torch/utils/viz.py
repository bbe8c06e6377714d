"""Visualization helpers: depth colorization and optical-flow rendering,
numpy only.

Port of ``dynibar_tpu.utils.viz`` (reference utils.py:52-170 and
ibrnet/data_loaders/flow_utils.py:24-152).  The JAX ``colorize_np`` calls
matplotlib, which the machine with the card does not have, so the two
colormaps the training panels use, ``jet`` and ``gray``, are built here as
matplotlib builds them: a 256-entry table interpolated from the same
segment data, indexed by ``int(x * 256)`` clipped to the last entry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# matplotlib's _cm.py segment data: (x, y_left, y_right) per channel
_SEGMENTS = {
    "jet": {
        "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
                (1.0, 0.5, 0.5)),
        "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
                  (0.91, 0, 0), (1.0, 0, 0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
                 (1.0, 0, 0))},
    "gray": {c: ((0.0, 0, 0), (1.0, 1, 1)) for c in ("red", "green", "blue")},
}
_N = 256


def _lookup_table(segments) -> np.ndarray:
  """matplotlib.colors._create_lookup_table at gamma 1."""
  adata = np.asarray(segments, np.float64)
  x, y0, y1 = adata[:, 0], adata[:, 1], adata[:, 2]
  xind = np.linspace(0, 1, _N)
  ind = np.searchsorted(x, xind)[1:-1]
  distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
  lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                        + y1[ind - 1], [y0[-1]]])
  return np.clip(lut, 0.0, 1.0)


_TABLES = {name: np.stack([_lookup_table(seg[c])
                           for c in ("red", "green", "blue")], axis=-1)
           for name, seg in _SEGMENTS.items()}


def apply_cmap(x: np.ndarray, cmap_name: str) -> np.ndarray:
  """Values in [0, 1] -> RGB in [0, 1] ([..., 3], f64), as matplotlib's
  ``get_cmap(name)(x)[..., :3]``."""
  if cmap_name not in _TABLES:
    raise ValueError(f"colormap {cmap_name!r}: the port has "
                     f"{sorted(_TABLES)}")
  idx = np.clip((np.asarray(x, np.float64) * _N).astype(int), 0, _N - 1)
  return _TABLES[cmap_name][idx]


def colorize_np(x: np.ndarray, cmap_name: str = "jet",
                mask: Optional[np.ndarray] = None,
                value_range: Optional[Tuple[float, float]] = None
                ) -> np.ndarray:
  """Grayscale [H, W] -> RGB [H, W, 3] float32 through a colormap."""
  x = np.array(x, dtype=np.float64, copy=True)
  if value_range is not None:
    vmin, vmax = value_range
  elif mask is not None:
    valid = x[mask]
    nz = valid[np.nonzero(valid)]
    vmin = nz.min() if nz.size else 0.0
    vmax = valid.max() if valid.size else 1.0
    x[np.logical_not(mask)] = vmin
  else:
    vmin, vmax = np.percentile(x, (1, 99))
    vmax += 1e-6
  x = np.clip((np.clip(x, vmin, vmax) - vmin) / (vmax - vmin), 0.0, 1.0)
  rgb = apply_cmap(x, cmap_name)
  if mask is not None:
    m = np.float32(mask[:, :, None])
    rgb = rgb * m + (1.0 - m)
  return rgb.astype(np.float32)


def _make_color_wheel() -> np.ndarray:
  ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
  ncols = ry + yg + gc + cb + bm + mr
  wheel = np.zeros([ncols, 3])
  col = 0
  wheel[0:ry, 0] = 255
  wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
  col += ry
  wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
  wheel[col:col + yg, 1] = 255
  col += yg
  wheel[col:col + gc, 1] = 255
  wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
  col += gc
  wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
  wheel[col:col + cb, 2] = 255
  col += cb
  wheel[col:col + bm, 2] = 255
  wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
  col += bm
  wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
  wheel[col:col + mr, 0] = 255
  return wheel


_COLOR_WHEEL = _make_color_wheel()


def flow_to_image(flow: np.ndarray, max_flow_clip: float = 1e7
                  ) -> np.ndarray:
  """Middlebury flow visualization, [H, W, 2] -> uint8 [H, W, 3]."""
  u, v = flow[..., 0].copy(), flow[..., 1].copy()
  bad = (np.abs(u) > max_flow_clip) | (np.abs(v) > max_flow_clip)
  u[bad] = 0
  v[bad] = 0
  rad = np.sqrt(u ** 2 + v ** 2)
  maxrad = max(-1.0, rad.max())
  u = u / (maxrad + np.finfo(float).eps)
  v = v / (maxrad + np.finfo(float).eps)

  ncols = _COLOR_WHEEL.shape[0]
  rad = np.sqrt(u ** 2 + v ** 2)
  a = np.arctan2(-v, -u) / np.pi
  fk = (a + 1) / 2 * (ncols - 1) + 1
  k0 = np.floor(fk).astype(int)
  k1 = k0 + 1
  k1[k1 == ncols + 1] = 1
  f = fk - k0

  img = np.zeros(u.shape + (3,), dtype=np.uint8)
  for i in range(3):
    col0 = _COLOR_WHEEL[(k0 - 1) % ncols, i] / 255.0
    col1 = _COLOR_WHEEL[(k1 - 1) % ncols, i] / 255.0
    col = (1 - f) * col0 + f * col1
    idx = rad <= 1
    col[idx] = 1 - rad[idx] * (1 - col[idx])
    col[~idx] *= 0.75
    img[:, :, i] = np.floor(255 * col).astype(np.uint8)
  return img
