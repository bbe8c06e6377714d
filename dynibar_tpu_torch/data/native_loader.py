"""ctypes bindings of the port's host image decoder (csrc/image_loader.cc).

Port of ``dynibar_tpu.data.native_loader``.  The C++ library decodes PNG
and JPEG with no image library, byte for byte as ``data/png.py`` and
``data/jpeg.py`` do, and is built from the repository with the host C++
compiler at its first use (``ops/build.load_host``).  ctypes releases the
interpreter lock for each call, so the input pipeline's worker threads
decode in parallel.

  * :func:`decode_file` / :func:`read_shape`: one file, as
    ``llff.read_image`` / ``read_image_shape`` return it (uint8 [H, W] for
    grayscale, [H, W, C] otherwise);
  * :class:`NativeImageLoader`: a persistent pool of C++ threads that
    decodes a batch into float32 [N, h, w, 3] in [0, 1], gray broadcast and
    alpha dropped, resized as the JAX package's loader resizes.

There is no fallback: a library that does not build raises with the
compiler's output, a file the decoder refuses raises ValueError with the
numpy decoder's message (zlib.error for a PNG's broken zlib stream, as
there), and a file that cannot be read raises OSError.
"""

from __future__ import annotations

import ctypes
import functools
import os
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from dynibar_tpu_torch.ops import build

_ERR_LEN = 1024
_ZLIB_ERROR = 2          # the library's code for a stream it cannot inflate


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = build.load_host("image_loader")
  c_int_p = ctypes.POINTER(ctypes.c_int)
  lib.dyn_decode_file.restype = ctypes.c_int
  lib.dyn_decode_file.argtypes = [
      ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
      c_int_p, ctypes.c_char_p, ctypes.c_int]
  lib.dyn_read_shape.restype = ctypes.c_int
  lib.dyn_read_shape.argtypes = [ctypes.c_char_p, c_int_p, ctypes.c_char_p,
                                 ctypes.c_int]
  lib.dyn_free.argtypes = [ctypes.c_void_p]
  lib.dyn_loader_create.restype = ctypes.c_void_p
  lib.dyn_loader_create.argtypes = [ctypes.c_int]
  lib.dyn_loader_destroy.argtypes = [ctypes.c_void_p]
  lib.dyn_loader_decode_batch.restype = ctypes.c_int
  lib.dyn_loader_decode_batch.argtypes = [
      ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
      ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
      ctypes.c_char_p, ctypes.c_int]
  return lib


def _raise(rc: int, err, path: str):
  if rc < 0:
    raise OSError(-rc, os.strerror(-rc), path)
  msg = err.value.decode(errors="replace")
  raise zlib.error(msg) if rc == _ZLIB_ERROR else ValueError(msg)


def _shape(h: int, w: int, c: int):
  return (h, w) if c == 1 else (h, w, c)


def decode_file(path: str) -> np.ndarray:
  """A PNG or JPEG file (by its magic bytes) -> uint8 [H, W(, C)]."""
  lib = _lib()
  data = ctypes.POINTER(ctypes.c_uint8)()
  shape = (ctypes.c_int * 3)()
  err = ctypes.create_string_buffer(_ERR_LEN)
  rc = lib.dyn_decode_file(os.fsencode(path), ctypes.byref(data), shape,
                           err, _ERR_LEN)
  if rc:
    _raise(rc, err, path)
  h, w, c = shape
  try:
    out = np.ctypeslib.as_array(data, (h * w * c,)).copy()
  finally:
    lib.dyn_free(data)
  return out.reshape(_shape(h, w, c))


def read_shape(path: str):
  """(height, width[, channels]) from the file's header."""
  shape = (ctypes.c_int * 3)()
  err = ctypes.create_string_buffer(_ERR_LEN)
  rc = _lib().dyn_read_shape(os.fsencode(path), shape, err, _ERR_LEN)
  if rc:
    _raise(rc, err, path)
  return _shape(*shape)


class NativeImageLoader:
  """Threaded native decoder; ``decode(paths, h, w) -> [N, h, w, 3] f32``."""

  def __init__(self, num_threads: int = 4):
    self._lib = _lib()
    self._handle = self._lib.dyn_loader_create(num_threads)

  def image_size(self, path: str) -> Tuple[int, int]:
    return read_shape(path)[:2]

  def decode(self, paths: Sequence[str], out_h: int = 0, out_w: int = 0
             ) -> np.ndarray:
    """Decode a batch of files, resized to (out_h, out_w) when both are
    set, else to the first file's size."""
    paths: List[str] = list(paths)
    n = len(paths)
    if out_h == 0 or out_w == 0:
      out_h, out_w = self.image_size(paths[0])
    out = np.empty((n, out_h, out_w, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = self._lib.dyn_loader_decode_batch(
        self._handle, arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
        err, _ERR_LEN)
    if rc:
      raise IOError(f"native decode failed for {paths[rc - 1]}: "
                    f"{err.value.decode(errors='replace')}")
    return out

  def close(self) -> None:
    if getattr(self, "_handle", None):
      self._lib.dyn_loader_destroy(self._handle)
      self._handle = None

  def __del__(self):
    self.close()
