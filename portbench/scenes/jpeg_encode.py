"""Frozen copy of the baseline JPEG writer of dynibar_tpu_torch/data/jpeg.py
(commit a749e58): ``encode`` and ``write``, for the ground truth of the
seeded Nvidia-layout scene.  The machine with the card has no image
library, so the scene writer carries its own encoder.
"""

from __future__ import annotations

from typing import List

import numpy as np

SOI = b"\xff\xd8"
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = tuple(int(z) for z in _ZIGZAG)

# islow DCT constants (jfdctint.c, 13-bit fixed point)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


# --- encoding ---------------------------------------------------------------
# A baseline writer with the defaults of libjpeg as PIL and imageio call it:
# JFIF 1.01, quality 75 (the Annex K tables scaled by jcparam.c), 4:2:0 for
# colour, the fixed-point RGB -> YCbCr tables (jccolor.c), h2v2 box
# downsampling with libjpeg's alternating rounding bias (jcsample.c), the
# integer "islow" forward DCT (jfdctint.c), round-half-away quantisation
# (jcdctmgr.c), the standard Huffman tables (Annex K.3) and no restart
# markers.  Every step runs on all blocks at once.

# ITU T.81 Annex K.1, row-major
_Q_BASE = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
           np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                    + [99] * 32))


def _ac_values(head: List[int]) -> bytes:
  """An Annex K.3 AC table's symbols: its first (shorter-code) symbols as
  listed, then every other symbol in ascending order."""
  every = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
  return bytes(head + sorted(set(every) - set(head)))


# Annex K.3: (class, id) -> (code counts per length 1..16, symbols)
_HUFF_SPEC = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
             _ac_values([
                 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31,
                 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
                 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
                 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82])),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
             _ac_values([
                 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06,
                 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
                 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
                 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
                 0xE1, 0x25, 0xF1])),
}


def _huffman_codes(counts: bytes, symbols: bytes):
  """Canonical codes (ITU T.81 C.2): (code, length) arrays by symbol."""
  code = np.zeros(256, np.int64)
  size = np.zeros(256, np.int64)
  c, k = 0, 0
  for length in range(1, 17):
    for _ in range(counts[length - 1]):
      code[symbols[k]], size[symbols[k]] = c, length
      c, k = c + 1, k + 1
    c <<= 1
  return code, size


# jcparam.c's jpeg_set_quality at quality 75: the Annex K tables scaled by
# 200 - 2 * 75 percent, rounded, at most 255 (baseline)
_QTABS = tuple(np.clip((b * (200 - 2 * 75) + 50) // 100, 1, 255)
               for b in _Q_BASE)


def _rgb_to_ycc(rgb: np.ndarray) -> List[np.ndarray]:
  """jccolor.c rgb_ycc_convert with its fixed-point tables (SCALEBITS 16)."""
  def fix(v):
    return int(v * 65536 + 0.5)

  r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
  half, off = 1 << 15, 128 << 16
  y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
  cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half
        - 1) >> 16
  cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half
        - 1) >> 16
  return [y, cb, cr]


def _edge_pad(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
  return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])),
                mode="edge")


def _fdct_1d(x: np.ndarray, shift_even: int, shift_odd: int) -> np.ndarray:
  """One pass of jfdctint.c's jpeg_fdct_islow over axis 1 of x [N, 8, 8]
  (int64); even outputs 0 and 4 shift left by -shift_even when it is
  negative (pass 1) or descale by it, the rest descale by shift_odd."""
  f = _F
  d = [x[:, k] for k in range(8)]
  tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
  tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
  tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
  tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
  tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
  tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

  def descale(v, n):
    return (v + (1 << (n - 1))) >> n

  out = [None] * 8
  if shift_even < 0:
    out[0] = (tmp10 + tmp11) << -shift_even
    out[4] = (tmp10 - tmp11) << -shift_even
  else:
    out[0] = descale(tmp10 + tmp11, shift_even)
    out[4] = descale(tmp10 - tmp11, shift_even)
  z1 = (tmp12 + tmp13) * f["f0541"]
  out[2] = descale(z1 + tmp13 * f["f0765"], shift_odd)
  out[6] = descale(z1 - tmp12 * f["f1847"], shift_odd)
  z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
  z5 = (z3 + z4) * f["f1175"]
  tmp4, tmp5 = tmp4 * f["f0298"], tmp5 * f["f2053"]
  tmp6, tmp7 = tmp6 * f["f3072"], tmp7 * f["f1501"]
  z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
  z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
  out[7] = descale(tmp4 + z1 + z3, shift_odd)
  out[5] = descale(tmp5 + z2 + z4, shift_odd)
  out[3] = descale(tmp6 + z2 + z3, shift_odd)
  out[1] = descale(tmp7 + z1 + z4, shift_odd)
  return np.stack(out, axis=1)


def _forward(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
  """uint8 samples [N, 8, 8] -> quantised coefficients [N, 64] in zigzag
  order: level shift, jpeg_fdct_islow (outputs scaled by 8) and
  jcdctmgr.c's division by 8 q rounding half away from zero."""
  x = blocks.astype(np.int64) - 128
  # pass 1 over the rows (axis 2), pass 2 over the columns (axis 1)
  ws = np.swapaxes(_fdct_1d(np.swapaxes(x, 1, 2), -2, 13 - 2), 1, 2)
  coef = _fdct_1d(ws, 2, 13 + 2).reshape(-1, 64)
  div = 8 * q[None, :]
  mag = (np.abs(coef) + div // 2) // div
  return np.where(coef < 0, -mag, mag)[:, _ZIGZAG]


def _blocks(plane: np.ndarray, nby: int, nbx: int) -> np.ndarray:
  """[nby * 8, nbx * 8] -> [nby, nbx, 8, 8]."""
  return plane[:nby * 8, :nbx * 8].reshape(nby, 8, nbx, 8).swapaxes(1, 2)


def _bit_length(v: np.ndarray) -> np.ndarray:
  a = np.abs(v)
  n = np.zeros(a.shape, np.int64)
  for k in range(16):
    n += a >= (1 << k)
  return n


def _entropy_code(coef: np.ndarray, table: np.ndarray, comp: np.ndarray
                  ) -> bytes:
  """Huffman-code blocks [N, 64] (zigzag, in scan order) with the
  standard tables (`table`: 0 luma, 1 chroma, per block), each
  component's DC predicted from its previous block (`comp` per block);
  byte stuffing done, the last byte padded with ones."""
  n = coef.shape[0]
  codes = {k: _huffman_codes(*v) for k, v in _HUFF_SPEC.items()}
  dc_code = np.stack([codes[(0, t)][0] for t in (0, 1)])
  dc_size = np.stack([codes[(0, t)][1] for t in (0, 1)])
  ac_code = np.stack([codes[(1, t)][0] for t in (0, 1)])
  ac_size = np.stack([codes[(1, t)][1] for t in (0, 1)])
  # DC differences along each component's own blocks
  dc = coef[:, 0]
  diff = np.empty(n, np.int64)
  for c in np.unique(comp):
    sel = np.nonzero(comp == c)[0]
    diff[sel] = np.diff(dc[sel], prepend=0)
  nb = _bit_length(diff)
  extra = np.where(diff < 0, diff - 1, diff) & ((1 << nb) - 1)
  vals = [(dc_code[table, nb] << nb) | extra]
  lens = [dc_size[table, nb] + nb]
  keys = [np.arange(n, dtype=np.int64) * 1024]
  # AC: one symbol per nonzero coefficient, (run % 16, size), after
  # run // 16 ZRL symbols; EOB unless the last coefficient is nonzero
  b, k = np.nonzero(coef[:, 1:])
  k = k + 1
  v = coef[b, k]
  prev = np.where(np.r_[True, b[1:] != b[:-1]], 0, np.r_[0, k[:-1]])
  run = k - prev - 1
  nb = _bit_length(v)
  t = table[b]
  sym = ((run & 15) << 4) | nb
  extra = np.where(v < 0, v - 1, v) & ((1 << nb) - 1)
  vals.append((ac_code[t, sym] << nb) | extra)
  lens.append(ac_size[t, sym] + nb)
  keys.append(b * 1024 + k * 8 + 4)
  nzrl = run >> 4
  zb = np.repeat(np.arange(len(b)), nzrl)
  if zb.size:
    j = np.arange(zb.size) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    vals.append(ac_code[t[zb], 0xF0])
    lens.append(ac_size[t[zb], 0xF0])
    keys.append(b[zb] * 1024 + k[zb] * 8 + j)
  last = np.zeros(n, np.int64)
  np.maximum.at(last, b, k)
  eob = np.nonzero(last < 63)[0]
  vals.append(ac_code[table[eob], 0x00])
  lens.append(ac_size[table[eob], 0x00])
  keys.append(eob * 1024 + 600)
  order = np.argsort(np.concatenate(keys), kind="stable")
  vals = np.concatenate(vals)[order]
  lens = np.concatenate(lens)[order]
  # pack: bit p of the stream is bit (end - 1 - p) of its symbol's value
  ends = np.cumsum(lens)
  owner = np.repeat(np.arange(len(lens)), lens)
  pos = np.arange(int(ends[-1]), dtype=np.int64)
  bits = (vals[owner] >> (ends[owner] - 1 - pos)) & 1
  bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])
  data = np.packbits(bits.astype(np.uint8))
  ff = np.nonzero(data == 0xFF)[0]
  return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
  return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode(img: np.ndarray) -> bytes:
  """uint8 [H, W] (grayscale) or [H, W, 3] (RGB) -> baseline JPEG bytes:
  the file PIL writes with its defaults (quality 75, 4:2:0 for colour)."""
  img = np.asarray(img)
  if img.dtype != np.uint8 or not (
      img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
    raise ValueError(f"JPEG encode takes uint8 [H, W] or [H, W, 3], got "
                     f"{img.dtype} {img.shape}")
  h, w = img.shape[:2]
  qtabs = _QTABS
  gray = img.ndim == 2
  if gray:
    nby, nbx = -(-h // 8), -(-w // 8)
    plane = _edge_pad(img.astype(np.int64), nby * 8, nbx * 8)
    coef = _forward(_blocks(plane, nby, nbx).reshape(-1, 8, 8), qtabs[0])
    table = comp = np.zeros(len(coef), np.int64)
    sof_comps = bytes([1, 1, 0x11, 0])
    sos_comps = bytes([1, 1, 0x00])
  else:
    y, cb, cr = _rgb_to_ycc(img)
    mcuy, mcux = -(-h // 16), -(-w // 16)
    # luma: the right edge replicated to whole blocks, the bottom to whole
    # MCU rows (jcsample.c, jcprepct.c); blocks past the image's last
    # block row or column are jccoefct.c's dummies
    nby, nbx = -(-h // 8), -(-w // 8)
    yq = _forward(_blocks(_edge_pad(y, mcuy * 16, nbx * 8), nby, nbx)
                  .reshape(-1, 8, 8), qtabs[0]).reshape(nby, nbx, 64)
    ycoef = np.zeros((mcuy * 2, mcux * 2, 64), np.int64)
    ycoef[:nby, :nbx] = yq
    if nbx < mcux * 2:        # right dummy: the DC of the block to its left
      ycoef[:nby, nbx, 0] = yq[:, nbx - 1, 0]
    if nby < mcuy * 2:        # bottom dummies: the DC of the MCU's last
      ycoef[nby, :, 0] = ycoef[nby - 1, 1::2, 0].repeat(2)   # upper block
    ymcu = ycoef.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4)
    # chroma: rows padded to even, columns to whole output blocks, then
    # 2x2 sums with the bias 1, 2, 1, 2, ... along each row, then the
    # bottom replicated to whole MCU rows
    chroma = []
    for c in (cb, cr):
      full = _edge_pad(c, -(-h // 2) * 2, mcux * 16)
      s = full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] \
          + full[1::2, 1::2]
      bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
      down = _edge_pad((s + bias) >> 2, mcuy * 8, mcux * 8)
      chroma.append(_forward(_blocks(down, mcuy, mcux).reshape(-1, 8, 8),
                             qtabs[1]).reshape(mcuy, mcux, 1, 64))
    coef = np.concatenate([ymcu.reshape(mcuy, mcux, 4, 64)] + chroma,
                          axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcuy * mcux)
    table = np.minimum(comp, 1)
    sof_comps = bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos_comps = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11])
  out = [SOI, _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
  for tid in range(1 if gray else 2):
    out.append(_segment(0xDB, bytes([tid]) + bytes(
        qtabs[tid][_ZIGZAG].astype(np.uint8))))
  out.append(_segment(0xC0, bytes([8]) + h.to_bytes(2, "big")
                      + w.to_bytes(2, "big") + sof_comps))
  for tid in range(1 if gray else 2):
    for cls in (0, 1):
      counts, symbols = _HUFF_SPEC[(cls, tid)]
      out.append(_segment(0xC4, bytes([(cls << 4) | tid]) + counts
                          + symbols))
  out.append(_segment(0xDA, sos_comps + bytes([0, 63, 0])))
  out.append(_entropy_code(coef, table, comp))
  out.append(b"\xff\xd9")
  return b"".join(out)


def write(path: str, img: np.ndarray) -> None:
  with open(path, "wb") as fh:
    fh.write(encode(img))
