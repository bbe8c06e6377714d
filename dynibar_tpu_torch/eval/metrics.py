"""Image quality metrics: masked PSNR and SSIM.

The port's copy of ``dynibar_tpu.eval.metrics`` (numpy and scipy only).
Parity targets: reference eval_nvidia.py:201-247.

PSNR is the reference's masked formula verbatim (:201-225).

SSIM replicates ``skimage.metrics.structural_similarity(img1, img2,
multichannel=True, full=True)`` **including its float-input defaults**, since
that is exactly what the reference calls (:242-244):
  * uniform 7×7 filter (gaussian_weights=False),
  * K1=0.01, K2=0.03,
  * data_range = 2.0 — skimage infers the range from the dtype, and for
    float inputs assumes [-1, 1].  The reference passes [0, 1] images without
    a data_range, so its published protocol quietly uses 2.0; we reproduce
    that, because changing it would make scores incomparable.
The per-channel SSIM maps are averaged, then mask-weighted like the
reference (:245-247).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import uniform_filter


def masked_psnr(img1: np.ndarray, img2: np.ndarray, mask: np.ndarray
                ) -> float:
  img1 = img1.astype(np.float64)
  img2 = img2.astype(np.float64)
  mask = mask.astype(np.float64)
  num_valid = np.sum(mask) + 1e-8
  mse = np.sum((img1 - img2) ** 2 * mask) / num_valid
  if mse == 0:
    return 0.0
  return 10 * math.log10(1.0 / mse)


def _ssim_map_single(x: np.ndarray, y: np.ndarray, data_range: float,
                     win_size: int = 7) -> np.ndarray:
  """skimage-compatible SSIM map for one channel (float64)."""
  k1, k2 = 0.01, 0.03
  np_ = win_size ** x.ndim
  cov_norm = np_ / (np_ - 1)  # sample covariance

  filt = lambda im: uniform_filter(im, size=win_size)
  ux, uy = filt(x), filt(y)
  uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
  vx = cov_norm * (uxx - ux * ux)
  vy = cov_norm * (uyy - uy * uy)
  vxy = cov_norm * (uxy - ux * uy)

  r = data_range
  c1 = (k1 * r) ** 2
  c2 = (k2 * r) ** 2
  a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
  b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
  s = (a1 * a2) / (b1 * b2)

  # skimage crops win_size//2 border from the mean but returns the full map
  return s


def ssim_map(img1: np.ndarray, img2: np.ndarray,
             data_range: float = 2.0) -> np.ndarray:
  """Multichannel SSIM map, averaged over channels."""
  img1 = img1.astype(np.float64)
  img2 = img2.astype(np.float64)
  maps = [_ssim_map_single(img1[..., c], img2[..., c], data_range)
          for c in range(img1.shape[-1])]
  return np.mean(np.stack(maps, axis=-1), axis=-1)


def masked_ssim(img1: np.ndarray, img2: np.ndarray, mask: np.ndarray,
                data_range: float = 2.0) -> float:
  """Mask-weighted mean of the SSIM map (reference eval_nvidia.py:228-247).

  The reference weights the [H, W] SSIM map by the (possibly 3-channel)
  mask via broadcasting; we collapse the mask the same way its sum does.
  """
  if img1.shape != img2.shape:
    raise ValueError("Input images must have the same dimensions.")
  smap = ssim_map(img1, img2, data_range)
  mask = mask.astype(np.float64)
  num_valid = np.sum(mask) + 1e-8
  if mask.ndim == 3:
    return float(np.sum(smap[..., None] * mask) / num_valid)
  return float(np.sum(smap * mask) / num_valid)


def mse2psnr(mse: float) -> float:
  return float(-10.0 * np.log(mse + 1e-6) / np.log(10.0))
