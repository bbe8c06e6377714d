"""8-bit PNG decoding and encoding with the standard library's zlib.

The machine with the card has no image library (no imageio, PIL or cv2),
and the reference dataset layout stores its frames, masks and virtual
views as PNGs.  This module reads what the layout needs: non-interlaced
8-bit gray, gray+alpha, RGB and RGBA with any of the five row filters
(PNG specification, section 9), returned as imageio returns them (uint8
[H, W] for gray, [H, W, C] otherwise).  It writes 8-bit gray and RGB (and
RGBA) with filter 0 (None) on every row.  Palette, 16-bit and interlaced
images raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (gray, RGB, gray+alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
  pos = len(_SIGNATURE)
  while pos + 8 <= len(data):
    length, kind = struct.unpack(">I4s", data[pos:pos + 8])
    body = data[pos + 8:pos + 8 + length]
    crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
    if zlib.crc32(kind + body) != crc:
      raise ValueError(f"PNG chunk {kind!r}: bad CRC")
    yield kind, body
    pos += 12 + length


def _unfilter_slow(kind: int, raw, prior, bpp: int) -> bytearray:
  """Average (3) and Paeth (4): each byte depends on the one bpp to its
  left, so they run byte by byte."""
  out = bytearray(raw)
  n = len(out)
  if kind == 3:
    for i in range(n):
      left = out[i - bpp] if i >= bpp else 0
      out[i] = (out[i] + ((left + prior[i]) >> 1)) & 255
    return out
  for i in range(n):
    a = out[i - bpp] if i >= bpp else 0
    b = prior[i]
    c = prior[i - bpp] if i >= bpp else 0
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
    out[i] = (out[i] + pred) & 255
  return out


def decode(data: bytes) -> np.ndarray:
  """PNG bytes -> uint8 array ([H, W] gray, else [H, W, C])."""
  if data[:8] != _SIGNATURE:
    raise ValueError("not a PNG file")
  header, idat = None, []
  for kind, body in _chunks(data):
    if kind == b"IHDR":
      header = struct.unpack(">IIBBBBB", body)
    elif kind == b"IDAT":
      idat.append(body)
    elif kind == b"IEND":
      break
  if header is None:
    raise ValueError("PNG without IHDR")
  w, h, depth, color, _, _, interlace = header
  if depth != 8 or color not in _CHANNELS or interlace != 0:
    raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                     f"{color}, interlace {interlace} (8-bit gray, gray+"
                     "alpha, RGB or RGBA, not interlaced)")
  bpp = _CHANNELS[color]
  stride = w * bpp
  raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
  if raw.size != h * (stride + 1):
    raise ValueError("PNG image data has the wrong size")
  rows = raw.reshape(h, stride + 1)
  filters, rows = rows[:, 0], rows[:, 1:]
  out = np.empty((h, stride), np.uint8)
  prior = np.zeros(stride, np.uint8)
  for y in range(h):
    kind, row = int(filters[y]), rows[y]
    if kind == 0:
      out[y] = row
    elif kind == 1:      # Sub: a running sum per channel, modulo 256
      out[y] = np.cumsum(row.reshape(w, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    elif kind == 2:      # Up
      out[y] = row + prior
    elif kind in (3, 4):
      out[y] = np.frombuffer(
          _unfilter_slow(kind, row.tobytes(), prior.tobytes(), bpp),
          np.uint8)
    else:
      raise ValueError(f"PNG row filter {kind}")
    prior = out[y]
  img = out.reshape(h, w, bpp)
  return img[..., 0] if bpp == 1 else img


def read(path: str) -> np.ndarray:
  with open(path, "rb") as fh:
    return decode(fh.read())


def read_shape(path: str):
  """(height, width[, channels]) from the header alone."""
  with open(path, "rb") as fh:
    head = fh.read(33)
  if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
    raise ValueError(f"{path}: not a PNG file")
  w, h, _, color = struct.unpack(">IIBB", head[16:26])
  c = _CHANNELS.get(color, 1)
  return (h, w) if c == 1 else (h, w, c)


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack(">I", len(body)) + kind + body
          + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray, level: int = 6) -> bytes:
  """uint8 [H, W] (gray) or [H, W, 3|4] (RGB, RGBA) -> PNG bytes."""
  img = np.asarray(img)
  if img.dtype != np.uint8:
    raise ValueError(f"PNG encode takes uint8, got {img.dtype}")
  if img.ndim == 2:
    img = img[..., None]
  color = {1: 0, 3: 2, 4: 6}.get(img.shape[-1]) if img.ndim == 3 else None
  if color is None:
    raise ValueError(f"PNG encode takes [H, W] or [H, W, 3|4], got "
                     f"{img.shape}")
  h, w, c = img.shape
  rows = np.concatenate([np.zeros((h, 1), np.uint8),
                         np.ascontiguousarray(img).reshape(h, w * c)], 1)
  return (_SIGNATURE
          + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
          + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
          + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
  with open(path, "wb") as fh:
    fh.write(encode(img))
