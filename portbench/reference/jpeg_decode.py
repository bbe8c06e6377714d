"""Frozen copy of the JPEG decoder of dynibar_tpu_torch/data/jpeg.py at
commit a749e58 (the numpy twin of the port's C++ host decoder), part of
the benchmark's plain reference: it decodes the ground truth the
reference scores against.

8-bit Huffman JPEG decoding with numpy and the standard library.

The machine with the card has no image library, and scenes in the
reference layout may store their frames as JPEGs (``images/*.jpg``), which
the JAX package reads through imageio.  This module decodes what such
scenes hold: baseline and extended-Huffman sequential JPEG (SOF0, SOF1)
and progressive JPEG (SOF2: spectral selection, successive approximation
and EOB runs, ITU T.81 G.1.2) with 8-bit samples, grayscale or YCbCr (and
RGB-coded, per the Adobe marker or the component ids), 4:4:4, 4:2:2 or
4:2:0 sampling, interleaved or one scan per component, with restart
markers.  Once every scan has run, both kinds share one back end, which
reproduces libjpeg's
default decode (the library behind imageio's): the integer "slow" inverse
DCT (jidctint.c), the "fancy" triangle-filter chroma upsampling
(jdsample.c h2v1 / h2v2) and the fixed-point YCbCr -> RGB tables
(jdcolor.c).  Returns uint8 [H, W] for grayscale, [H, W, 3] otherwise, as
imageio does.  Arithmetic-coded, lossless, hierarchical, 12-bit and CMYK
files, and other sampling layouts, raise ValueError naming the file.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

SOI = b"\xff\xd8"

# the zigzag scan: position in the stream -> row-major index in the block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = tuple(int(z) for z in _ZIGZAG)

_SOF_NAMES = {0xC3: "lossless", 0xC5: "hierarchical",
              0xC6: "hierarchical", 0xC7: "hierarchical",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
              0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
              0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


class _Frame:
  def __init__(self, h: int, w: int, comps: List[Tuple[int, int, int, int]],
               progressive: bool = False):
    self.h, self.w = h, w
    self.progressive = progressive
    self.ids = [c[0] for c in comps]
    self.hs = [c[1] for c in comps]
    self.vs = [c[2] for c in comps]
    self.tq = [c[3] for c in comps]
    self.hmax, self.vmax = max(self.hs), max(self.vs)
    self.mcux = -(-w // (8 * self.hmax))
    self.mcuy = -(-h // (8 * self.vmax))
    # each component's coefficient blocks, the whole MCU grid
    self.coef = [np.zeros((self.mcuy * v, self.mcux * hh, 64), np.int32)
                 for hh, v in zip(self.hs, self.vs)]
    # a progressive file's blocks as lists of 64 ints while its scans
    # refine them (faster to index from Python), moved into coef after
    self.lists = ([[[[0] * 64 for _ in range(c.shape[1])]
                    for _ in range(c.shape[0])] for c in self.coef]
                  if progressive else None)

  def comp_size(self, i: int) -> Tuple[int, int]:
    """(height, width) of component i's samples (jdinput.c)."""
    return (-(-self.h * self.vs[i] // self.vmax),
            -(-self.w * self.hs[i] // self.hmax))


def _huffman_table(counts: bytes, symbols: bytes):
  """Canonical codes -> (code length, symbol) lookups on a 16-bit window."""
  lens = [0] * 65536
  syms = [0] * 65536
  code, k = 0, 0
  for length in range(1, 17):
    for _ in range(counts[length - 1]):
      lo = code << (16 - length)
      hi = (code + 1) << (16 - length)
      lens[lo:hi] = [length] * (hi - lo)
      syms[lo:hi] = [symbols[k]] * (hi - lo)
      code += 1
      k += 1
    code <<= 1
  return lens, syms


def _windows(segment: bytes) -> List[int]:
  """The 16 bits from every bit position of an entropy-coded segment (byte
  stuffing removed), padded with ones as a decoder reading past the end
  would see them."""
  bits = np.unpackbits(np.frombuffer(segment, np.uint8)).astype(np.uint32)
  bits = np.concatenate([bits, np.ones(32, np.uint32)])
  n = bits.size - 16
  win = np.zeros(n, np.uint32)
  for i in range(16):
    win = (win << 1) | bits[i:i + n]
  return win.tolist()


def _extend(v: int, t: int) -> int:
  return v - (1 << t) + 1 if v < (1 << (t - 1)) else v


def _decode_segment(win: List[int], units, dc_tabs, ac_tabs, pred,
                    frame: _Frame) -> None:
  """Decode `units` (component, block row, block column) in order from one
  restart interval; DC predictors in `pred` (per component)."""
  pos = 0
  for ci, by, bx in units:
    dlens, dsyms = dc_tabs[ci]
    alens, asyms = ac_tabs[ci]
    blk = frame.coef[ci][by, bx]
    w = win[pos]
    t = dsyms[w]
    pos += dlens[w]
    diff = 0
    if t:
      diff = _extend(win[pos] >> (16 - t), t)
      pos += t
    pred[ci] += diff
    blk[0] = pred[ci]
    k = 1
    while k < 64:
      w = win[pos]
      rs = asyms[w]
      pos += alens[w]
      r, s = rs >> 4, rs & 15
      if s == 0:
        if r != 15:
          break                    # end of block
        k += 16
        continue
      k += r
      blk[_ZIGZAG[k]] = _extend(win[pos] >> (16 - s), s)
      pos += s
      k += 1


def _receive(win: List[int], pos: int, n: int) -> int:
  """n (<= 16) raw bits from bit position pos."""
  return win[pos] >> (16 - n) if n else 0


def _dc_first(win, blocks, tabs, al: int, pred) -> None:
  """A progressive DC first scan (jdphuff.c decode_mcu_DC_first): the
  predicted DC, scaled by 2^al, into coefficient 0 of each block."""
  pos = 0
  for ci, blk in blocks:
    lens, syms = tabs[ci]
    w = win[pos]
    t = syms[w]
    pos += lens[w]
    if t:
      pred[ci] += _extend(_receive(win, pos, t), t)
      pos += t
    blk[0] = pred[ci] << al


def _dc_refine(win, blocks, al: int) -> None:
  """A DC refinement scan: one raw bit per block, bit al of its DC."""
  for pos, (_, blk) in enumerate(blocks):
    if win[pos] >> 15:
      blk[0] |= 1 << al


def _ac_first(win, blocks, tab, ss: int, se: int, al: int) -> None:
  """A progressive AC first scan (decode_mcu_AC_first) of one component:
  coefficients ss..se scaled by 2^al, with end-of-band runs."""
  lens, syms = tab
  pos = eobrun = 0
  for _, blk in blocks:
    if eobrun:
      eobrun -= 1
      continue
    k = ss
    while k <= se:
      w = win[pos]
      rs = syms[w]
      pos += lens[w]
      r, s = rs >> 4, rs & 15
      if s:
        k += r
        blk[_ZZ[k]] = _extend(_receive(win, pos, s), s) << al
        pos += s
        k += 1
      elif r == 15:
        k += 16
      else:
        eobrun = (1 << r) - 1 + _receive(win, pos, r)
        pos += r
        break


def _ac_refine(win, blocks, tab, ss: int, se: int, al: int) -> None:
  """A progressive AC refinement scan (decode_mcu_AC_refine): one
  correction bit for every coefficient already nonzero that it passes,
  and new coefficients of magnitude 2^al placed after r zero ones."""
  lens, syms = tab
  p1, m1 = 1 << al, -1 << al
  pos = eobrun = 0
  for _, blk in blocks:
    k = ss
    if not eobrun:
      while k <= se:
        w = win[pos]
        rs = syms[w]
        pos += lens[w]
        r, s = rs >> 4, rs & 15
        if s:
          s = p1 if win[pos] >> 15 else m1
          pos += 1
        elif r != 15:
          eobrun = (1 << r) + _receive(win, pos, r)
          pos += r
          break
        while k <= se:
          z = _ZZ[k]
          c = blk[z]
          if c:
            if win[pos] >> 15 and not c & p1:
              blk[z] = c + (p1 if c >= 0 else m1)
            pos += 1
          else:
            r -= 1
            if r < 0:
              break
          k += 1
        if s:
          blk[_ZZ[k]] = s
        k += 1
    if eobrun:
      while k <= se:
        z = _ZZ[k]
        c = blk[z]
        if c:
          if win[pos] >> 15 and not c & p1:
            blk[z] = c + (p1 if c >= 0 else m1)
          pos += 1
        k += 1
      eobrun -= 1


# jidctint.c constants (CONST_BITS 13, PASS1_BITS 2)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x, shift: int):
  """One pass of libjpeg's islow IDCT over axis 1 of x [N, 8, 8] (int64):
  returns the pass's 8 outputs, descaled by `shift` with rounding."""
  f = _F
  c = [x[:, k] for k in range(8)]
  z2, z3 = c[2], c[6]
  z1 = (z2 + z3) * f["f0541"]
  tmp2 = z1 + z3 * (-f["f1847"])
  tmp3 = z1 + z2 * f["f0765"]
  tmp0 = (c[0] + c[4]) << 13
  tmp1 = (c[0] - c[4]) << 13
  tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
  tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
  t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
  z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
  z5 = (z3 + z4) * f["f1175"]
  t0 = t0 * f["f0298"]
  t1 = t1 * f["f2053"]
  t2 = t2 * f["f3072"]
  t3 = t3 * f["f1501"]
  z1 = z1 * (-f["f0899"])
  z2 = z2 * (-f["f2562"])
  z3 = z3 * (-f["f1961"]) + z5
  z4 = z4 * (-f["f0390"]) + z5
  t0 = t0 + z1 + z3
  t1 = t1 + z2 + z4
  t2 = t2 + z2 + z3
  t3 = t3 + z1 + z4
  half = 1 << (shift - 1)
  out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
  return np.stack([(o + half) >> shift for o in out], axis=1)


def _idct(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
  """Dequantize and invert [N, 64] row-major coefficients: uint8 [N, 8, 8]
  as jidctint.c's jpeg_idct_islow computes them."""
  x = (blocks.astype(np.int64) * q[None, :]).reshape(-1, 8, 8)
  # pass 1 over the columns (axis 1 is the row index u of F[u][v])
  ws = _idct_1d(x, 13 - 2)                  # [N, 8 (y), 8 (v)]
  # pass 2 over the rows: the work array's rows are y, its columns v
  out = _idct_1d(np.swapaxes(ws, 1, 2), 13 + 2 + 3)   # [N, 8 x, 8 y]
  out = np.swapaxes(out, 1, 2)
  return np.clip(out + 128, 0, 255).astype(np.uint8)


def _fancy(comp: np.ndarray, v2: bool) -> np.ndarray:
  """libjpeg's fancy upsampling of a component's samples [h, w] (uint8):
  h2v1 (4:2:2) or h2v2 (4:2:0); returns [h * (1 + v2), 2 w] uint8."""
  x = comp.astype(np.int32)
  h, w = x.shape
  if not v2:                                       # h2v1_fancy_upsample
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    even[:, 0] = x[:, 0]
    odd[:, -1] = x[:, -1]
    out = np.empty((h, 2 * w), np.int32)
    out[:, 0::2], out[:, 1::2] = even, odd
    return out.astype(np.uint8)
  # h2v2_fancy_upsample: column sums with the row above (upper output
  # row) or below (lower), edge rows replicated, then the same in x
  up = np.concatenate([x[:1], x[:-1]], 0)
  down = np.concatenate([x[1:], x[-1:]], 0)
  out = np.empty((2 * h, 2 * w), np.int32)
  for half, near in ((0, up), (1, down)):
    cs = 3 * x + near
    left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
    right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
    even = (3 * cs + left + 8) >> 4
    odd = (3 * cs + right + 7) >> 4
    even[:, 0] = (4 * cs[:, 0] + 8) >> 4
    odd[:, -1] = (4 * cs[:, -1] + 7) >> 4
    out[half::2, 0::2], out[half::2, 1::2] = even, odd
  return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
  """jdcolor.c ycc_rgb_convert with its fixed-point tables (SCALEBITS 16)."""
  one_half = 1 << 15

  def fix(v):
    return int(v * 65536 + 0.5)

  y = y.astype(np.int64)
  xb = cb.astype(np.int64) - 128
  xr = cr.astype(np.int64) - 128
  r = y + ((fix(1.40200) * xr + one_half) >> 16)
  b = y + ((fix(1.77200) * xb + one_half) >> 16)
  g = y + (((-fix(0.34414)) * xb + one_half + (-fix(0.71414)) * xr) >> 16)
  return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _segments(data: bytes, start: int) -> Tuple[List[bytes], int]:
  """The entropy-coded data of a scan from `start`, split at restart
  markers, byte stuffing removed; and the offset of the marker that ends
  the scan."""
  end = start
  while True:
    end = data.find(b"\xff", end)
    if end < 0 or end + 1 >= len(data):
      end = len(data)
      break
    nxt = data[end + 1]
    if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
      end += 1 if nxt == 0xFF else 2
      continue
    break
  parts = re.split(rb"\xff[\xd0-\xd7]", data[start:end])
  return [p.replace(b"\xff\x00", b"\xff") for p in parts], end


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
  """JPEG bytes -> uint8 [H, W] (grayscale) or [H, W, 3]."""
  if data[:2] != SOI:
    raise ValueError(f"{name}: not a JPEG file")
  qt: Dict[int, np.ndarray] = {}
  dc: Dict[int, tuple] = {}
  ac: Dict[int, tuple] = {}
  frame: Optional[_Frame] = None
  restart = 0
  adobe: Optional[int] = None
  pos = 2
  while pos < len(data):
    if data[pos] != 0xFF:
      raise ValueError(f"{name}: bad JPEG marker at byte {pos}")
    marker = data[pos + 1]
    pos += 2
    if marker == 0xFF:
      pos -= 1                                   # fill byte
      continue
    if marker == 0xD9:                           # EOI
      break
    if 0xD0 <= marker <= 0xD7 or marker == 0x01:
      continue
    length = int.from_bytes(data[pos:pos + 2], "big")
    body = data[pos + 2:pos + length]
    pos += length
    if marker in (0xC0, 0xC1, 0xC2):             # SOF0 / SOF1 / SOF2
      if body[0] != 8:
        raise ValueError(f"{name}: {body[0]}-bit JPEG samples (8 only)")
      h = int.from_bytes(body[1:3], "big")
      w = int.from_bytes(body[3:5], "big")
      comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                body[7 + 3 * i] & 15, body[8 + 3 * i])
               for i in range(body[5])]
      frame = _Frame(h, w, comps, progressive=marker == 0xC2)
    elif marker in _SOF_NAMES:
      raise ValueError(f"{name}: {_SOF_NAMES[marker]} JPEG is not "
                       "supported (Huffman sequential or progressive only)")
    elif marker == 0xC4:                         # DHT
      i = 0
      while i < len(body):
        cls, tid = body[i] >> 4, body[i] & 15
        counts = body[i + 1:i + 17]
        n = sum(counts)
        tab = _huffman_table(counts, body[i + 17:i + 17 + n])
        (ac if cls else dc)[tid] = tab
        i += 17 + n
    elif marker == 0xDB:                         # DQT
      i = 0
      while i < len(body):
        prec, tid = body[i] >> 4, body[i] & 15
        if prec:
          vals = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
          i += 129
        else:
          vals = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(
              np.int64)
          i += 65
        q = np.zeros(64, np.int64)
        q[_ZIGZAG] = vals
        qt[tid] = q
    elif marker == 0xDD:                         # DRI
      restart = int.from_bytes(body[0:2], "big")
    elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
      adobe = body[11]
    elif marker == 0xDA:                         # SOS
      if frame is None:
        raise ValueError(f"{name}: scan before the frame header")
      ns = body[0]
      sel = [(frame.ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4,
              body[2 + 2 * i] & 15) for i in range(ns)]
      parts, pos = _segments(data, pos)
      if frame.progressive:
        ss, se = body[1 + 2 * ns], body[2 + 2 * ns]
        ah, al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
        if ss and ns != 1:
          raise ValueError(f"{name}: a progressive AC scan of {ns} "
                           "components")
        _decode_progressive_scan(frame, sel, (ss, se, ah, al), parts,
                                 restart, dc, ac)
      else:
        _decode_scan(frame, sel, parts, restart, dc, ac)
  if frame is None:
    raise ValueError(f"{name}: no frame header")
  if frame.progressive:
    for coef, lists in zip(frame.coef, frame.lists):
      coef[...] = np.asarray(lists, np.int32)
  return _assemble(frame, qt, adobe, name)


def _scan_units(frame: _Frame, comps: List[int]):
  """A scan's blocks (component, block row, block column), one list per
  MCU: the component's own block grid when it is scanned alone."""
  if len(comps) == 1:                            # non-interleaved
    ci = comps[0]
    ch, cw = frame.comp_size(ci)
    nby, nbx = -(-ch // 8), -(-cw // 8)
    units = [[(ci, by, bx)] for by in range(nby) for bx in range(nbx)]
  else:
    units = []
    for my in range(frame.mcuy):
      for mx in range(frame.mcux):
        mcu = []
        for ci in comps:
          hh, v = frame.hs[ci], frame.vs[ci]
          mcu += [(ci, my * v + y, mx * hh + x)
                  for y in range(v) for x in range(hh)]
        units.append(mcu)
  return units


def _decode_scan(frame: _Frame, sel, parts: List[bytes], restart: int,
                 dc, ac) -> None:
  """Decode one sequential scan of the components `sel` (index, DC table,
  AC table) into the frame's coefficient blocks."""
  comps = [c for c, _, _ in sel]
  units = _scan_units(frame, comps)
  per = restart if restart else len(units)
  dc_tabs = {c: dc[d] for c, d, _ in sel}
  ac_tabs = {c: ac[a] for c, _, a in sel}
  for k, part in enumerate(parts):
    group = units[k * per:(k + 1) * per]
    if not group:
      break
    pred = {c: 0 for c in comps}
    _decode_segment(_windows(part), [u for mcu in group for u in mcu],
                    dc_tabs, ac_tabs, pred, frame)


def _decode_progressive_scan(frame: _Frame, sel, band, parts: List[bytes],
                             restart: int, dc, ac) -> None:
  """Decode one progressive scan: `band` is (Ss, Se, Ah, Al), the spectral
  band and the successive-approximation bits (T.81 G.1.2).  DC predictors
  and end-of-band runs restart at each restart marker."""
  ss, se, ah, al = band
  comps = [c for c, _, _ in sel]
  units = _scan_units(frame, comps)
  per = restart if restart else len(units)
  for k, part in enumerate(parts):
    group = units[k * per:(k + 1) * per]
    if not group:
      break
    win = _windows(part)
    blocks = [(ci, frame.lists[ci][by][bx])
              for mcu in group for ci, by, bx in mcu]
    if ss == 0 and ah == 0:
      _dc_first(win, blocks, {c: dc[d] for c, d, _ in sel}, al,
                {c: 0 for c in comps})
    elif ss == 0:
      _dc_refine(win, blocks, al)
    elif ah == 0:
      _ac_first(win, blocks, ac[sel[0][2]], ss, se, al)
    else:
      _ac_refine(win, blocks, ac[sel[0][2]], ss, se, al)


def _assemble(frame: _Frame, qt, adobe: Optional[int],
              name: str) -> np.ndarray:
  planes = []
  for ci in range(len(frame.ids)):
    coef = frame.coef[ci]
    nby, nbx = coef.shape[:2]
    pix = _idct(coef.reshape(-1, 64), qt[frame.tq[ci]])
    plane = pix.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(
        nby * 8, nbx * 8)
    ch, cw = frame.comp_size(ci)
    plane = plane[:ch, :cw]
    h2 = frame.hmax // frame.hs[ci]
    v2 = frame.vmax // frame.vs[ci]
    if (h2, v2) == (2, 2) or (h2, v2) == (2, 1):
      plane = _fancy(plane, v2 == 2)
    elif (h2, v2) != (1, 1):
      raise ValueError(f"{name}: JPEG chroma sampling {frame.hs}x"
                       f"{frame.vs} is not supported (4:4:4, 4:2:2, "
                       "4:2:0 only)")
    planes.append(plane[:frame.h, :frame.w])
  if len(planes) == 1:
    return planes[0]
  if len(planes) != 3:
    raise ValueError(f"{name}: {len(planes)}-component JPEG (CMYK) is "
                     "not supported")
  rgb_coded = adobe == 0 or tuple(frame.ids) == (82, 71, 66)
  if rgb_coded:
    return np.stack(planes, -1)
  return _ycc_to_rgb(*planes)


def read(path: str) -> np.ndarray:
  with open(path, "rb") as fh:
    return decode(fh.read(), path)


def read_shape(path: str):
  """(height, width[, 3]) from the frame header."""
  with open(path, "rb") as fh:
    data = fh.read()
  if data[:2] != SOI:
    raise ValueError(f"{path}: not a JPEG file")
  pos = 2
  while pos + 4 <= len(data):
    marker = data[pos + 1]
    if data[pos] != 0xFF or marker == 0xFF:
      pos += 1
      continue
    length = int.from_bytes(data[pos + 2:pos + 4], "big")
    if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
      body = data[pos + 4:pos + 2 + length]
      h = int.from_bytes(body[1:3], "big")
      w = int.from_bytes(body[3:5], "big")
      return (h, w) if body[5] == 1 else (h, w, 3)
    pos += 2 + length
  raise ValueError(f"{path}: no JPEG frame header")
