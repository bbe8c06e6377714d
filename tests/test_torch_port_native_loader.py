"""The port's host image decoder (csrc/image_loader.cc, bound by
data/native_loader.py) on the CPU:

  * one file at a time, it returns data/png.py's and data/jpeg.py's bytes
    exactly on PNG (imageio, PIL at every compression level including
    stored blocks, the port's writer; gray, gray+alpha, RGB, RGBA) and JPEG
    files (PIL and OpenCV, sequential and progressive, 4:4:4 / 4:2:2 /
    4:2:0, odd sizes, restart markers, grayscale, RGB-coded, the port's
    writer), and the header's shape;
  * it refuses what they refuse, with the same exception and message;
  * the batch entry equals the JAX package's NativeImageLoader
    (runtime/image_loader.cc: libpng and libjpeg) within 1e-6, with and
    without resize, gray and RGBA included; equals the single-file path
    broadcast and scaled at 1 and 4 threads; and its resize equals
    chip_smoke.py's numpy rendering of the JAX library's arithmetic
    exactly;
  * a missing file raises naming it; a refused file in a batch raises
    IOError naming it;
  * MonocularSceneData's batches are equal with either decoder, PNG and
    JPEG frames;
  * the library builds apart from the CUDA kernels, once when processes
    start together, and raises when the compiler is missing or fails.
"""

import importlib.util
import io
import pathlib
import re
import struct
import threading
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from dynibar_tpu.data.native_loader import NativeImageLoader as JLoader
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data import jpeg, llff, native_loader, png
from dynibar_tpu_torch.data import synthetic_scene
from dynibar_tpu_torch.data.monocular import MonocularSceneData
from dynibar_tpu_torch.ops import build
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = 40, 56


def _chip_smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke",
                                                ROOT / "chip_smoke.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _image(h, w, channels, seed):
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[0:h, 0:w]
  base = [np.sin(xx / 7.0 + yy / 11.0) * 100, np.cos(xx / 5.0) * 90,
          np.sin(yy / 3.0) * 60, np.cos(xx / 3.0 + yy / 9.0) * 100]
  img = np.stack([128 + b for b in base[:channels]], -1)
  img = np.clip(img + rng.normal(0, 15, img.shape), 0, 255).astype(np.uint8)
  return img[..., 0] if channels == 1 else img


def _pil(img, fmt, **kw):
  def write(path):
    Image.fromarray(img).save(path, format=fmt, **kw)
  return write


def _cv2(img, params):
  def write(path):
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    pathlib.Path(path).write_bytes(enc.tobytes())
  return write


def _imageio(img, **kw):
  return lambda path: imageio.imwrite(path, img, **kw)


def _specs(h, w, tag):
  """name -> (writer of the file, its extension); seeds by position."""
  rgb, gray = _image(h, w, 3, 1), _image(h, w, 1, 2)
  rgba, ga = _image(h, w, 4, 3), _image(h, w, 2, 4)
  specs = {
      "png_gray": (_imageio(gray), "png"),
      "png_gray_alpha": (_imageio(ga), "png"),
      "png_rgb": (_imageio(rgb), "png"),
      "png_rgba": (_imageio(rgba), "png"),
      "png_stored": (_pil(rgb, "PNG", compress_level=0), "png"),
      "png_level1": (_pil(rgb, "PNG", compress_level=1), "png"),
      "png_level9": (_pil(rgba, "PNG", compress_level=9), "png"),
      "png_port": (lambda p: png.write(p, rgb), "png"),
      "jpeg_gray": (_pil(gray, "JPEG", quality=85), "jpg"),
      "jpeg_gray_progressive": (_pil(gray, "JPEG", quality=85,
                                     progressive=True), "jpg"),
      "jpeg_rgb_coded": (_pil(rgb, "JPEG", quality=90, subsampling=0,
                              keep_rgb=True), "jpg"),
      "jpeg_port": (lambda p: jpeg.write(p, rgb), "jpg"),
  }
  for sub in (0, 1, 2):
    for q in (30, 95):
      specs[f"jpeg_q{q}_s{sub}"] = (_pil(rgb, "JPEG", quality=q,
                                         subsampling=sub), "jpg")
    specs[f"jpeg_progressive_s{sub}"] = (_pil(
        rgb, "JPEG", quality=75, subsampling=sub, progressive=True), "jpg")
  for rst in (1, 7):
    specs[f"jpeg_pil_progressive_rst{rst}"] = (_pil(
        rgb, "JPEG", quality=85, subsampling=2, progressive=True,
        restart_marker_blocks=rst), "jpg")
    specs[f"jpeg_cv2_rst{rst}"] = (_cv2(rgb, [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL,
        rst]), "jpg")
    specs[f"jpeg_cv2_progressive_rst{rst}"] = (_cv2(rgb, [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst]), "jpg")
  return {f"{tag}_{k}": v for k, v in specs.items()}


# the batch set at H x W, and odd sizes (the fancy upsampling's edges)
SPECS = dict(_specs(H, W, "even"), **_specs(61, 93, "odd61x93"),
             **_specs(33, 8, "odd33x8"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
  root = tmp_path_factory.mktemp("native_files")
  out = {}
  for name, (write, ext) in SPECS.items():
    path = str(root / f"{name}.{ext}")
    write(path)
    out[name] = path
  return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_decode_file_equals_the_numpy_decoder(files, name):
  path = files[name]
  want = llff.read_image(path, decoder="numpy")
  got = llff.read_image(path)
  assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  assert llff.read_image_shape(path) == llff.read_image_shape(
      path, decoder="numpy") == got.shape


def _refusals():
  """name -> bytes of a file both decoders refuse."""
  def sof(marker, bits=8):
    body = bytes([bits, 0, 8, 0, 8, 1, 1, 0x11, 0])
    return (b"\xff\xd8\xff" + bytes([marker])
            + (len(body) + 2).to_bytes(2, "big") + body + b"\xff\xd9")

  def chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))

  ihdr = chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0))
  rows = b"".join(bytes([7]) + bytes(12) for _ in range(4))
  sig = b"\x89PNG\r\n\x1a\n"
  img = _image(16, 24, 3, 5)
  out = {f"sof_{m:x}.jpg": sof(m) for m in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9,
                                           0xCA, 0xCB, 0xCD, 0xCE, 0xCF)}
  out.update({f"deep_{m:x}.jpg": sof(m, 12) for m in (0xC0, 0xC1, 0xC2)})
  out["noframe.jpg"] = b"\xff\xd8\xff\xd9"
  out["badmarker.jpg"] = b"\xff\xd8\x00\x00"
  out["scanfirst.jpg"] = (b"\xff\xd8\xff\xda\x00\x08\x01\x01\x00\x00\x3f"
                          b"\x00\xff\xd9")
  for prog in (False, True):
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, format="JPEG",
                                              progressive=prog)
    out[f"cmyk_{int(prog)}.jpg"] = buf.getvalue()
  ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
  assert ok
  out["s411.jpg"] = enc.tobytes()
  out["notpng.png"] = b"not an image file of any kind at all"
  buf = io.BytesIO()
  imageio.imwrite(buf, np.zeros((4, 4), np.uint16), format="png")
  out["depth16.png"] = buf.getvalue()
  buf = io.BytesIO()
  Image.fromarray(img).convert("P").save(buf, format="PNG")
  out["palette.png"] = buf.getvalue()
  good = bytearray(sig + ihdr + chunk(b"IDAT", zlib.compress(rows))
                   + chunk(b"IEND", b""))
  good[20] ^= 1
  out["crc.png"] = bytes(good)
  out["filter7.png"] = (sig + ihdr + chunk(b"IDAT", zlib.compress(rows))
                        + chunk(b"IEND", b""))
  out["size.png"] = (sig + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2,
                                                      0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows))
                     + chunk(b"IEND", b""))
  out["noihdr.png"] = sig + chunk(b"IDAT", zlib.compress(rows))
  out["zlib_header.png"] = sig + ihdr + chunk(b"IDAT", b"garbage!")
  out["zlib_truncated.png"] = sig + ihdr + chunk(
      b"IDAT", zlib.compress(rows)[:-6])
  out["interlaced.png"] = sig + chunk(b"IHDR", struct.pack(
      ">IIBBBBB", 4, 4, 8, 2, 0, 0, 1))
  return out


REFUSALS = sorted(_refusals())


def _outcome(fn, *args):
  try:
    return ("ok", fn(*args).shape)
  except Exception as exc:  # compared between the decoders
    return (type(exc), str(exc))


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_the_numpy_decoder(tmp_path, name):
  path = tmp_path / name
  path.write_bytes(_refusals()[name])
  want = _outcome(llff.read_image, str(path), "numpy")
  assert want[0] != "ok"
  assert _outcome(llff.read_image, str(path), "native") == want


@pytest.mark.parametrize("kind", ["png", "jpeg"])
@pytest.mark.parametrize("size", [None, (20, 28), (57, 83)])
def test_batch_matches_the_jax_loader(files, kind, size):
  """Down and up: the resize's arithmetic is the JAX library's.  (Gray+
  alpha is left out: the JAX library gives gray, alpha, alpha.)"""
  names = [n for n in sorted(files) if n.startswith(f"even_{kind}")
           and "alpha" not in n]
  paths = [files[n] for n in names]
  oh, ow = size or (0, 0)
  got = native_loader.NativeImageLoader(4).decode(paths, oh, ow)
  want = JLoader(2).decode(paths, oh, ow)
  assert got.shape == want.shape == (len(paths),) + (size or (H, W)) + (3,)
  diff = np.abs(got - want).reshape(len(paths), -1).max(1)
  bad = {n: int((np.abs(got[i] - want[i]) > 1e-6).sum())
         for i, n in enumerate(names) if diff[i] > 1e-6}
  assert not bad, f"pixels over 1e-6 by file: {bad}"


@pytest.mark.parametrize("threads", [1, 4])
def test_batch_equals_the_single_file_path(files, threads):
  names = [n for n in sorted(files) if n.startswith("even_")]
  got = native_loader.NativeImageLoader(threads).decode(
      [files[n] for n in names])
  inv255 = np.float32(1.0) / np.float32(255.0)
  for i, n in enumerate(names):
    one = llff.read_image(files[n])
    one = one[..., None] if one.ndim == 2 else one
    rgb = one[..., [0, 0, 0]] if one.shape[2] < 3 else one[..., :3]
    np.testing.assert_array_equal(got[i], rgb.astype(np.float32) * inv255,
                                  err_msg=n)


@pytest.mark.parametrize("size", [(20, 28), (57, 83), (H, W)])
def test_batch_resize_equals_the_numpy_rendering(files, size):
  resize = _chip_smoke()._resize_to_float
  names = [n for n in sorted(files) if n.startswith("even_")]
  got = native_loader.NativeImageLoader(3).decode([files[n] for n in names],
                                                 *size)
  for i, n in enumerate(names):
    want = resize(llff.read_image(files[n]), *size)
    np.testing.assert_array_equal(got[i], want, err_msg=n)
    assert np.isfinite(got[i]).all() and 0 <= got[i].min() <= got[
        i].max() <= 1


def test_missing_file_raises_naming_it(files, tmp_path):
  missing = str(tmp_path / "nowhere" / "frame.png")
  loader = native_loader.NativeImageLoader(2)
  with pytest.raises(IOError, match="frame.png"):
    loader.decode([files["even_png_rgb"], missing], 8, 8)
  for fn in (native_loader.decode_file, native_loader.read_shape,
             llff.read_image):
    with pytest.raises(FileNotFoundError) as err:
      fn(missing)
    assert err.value.filename == missing
  with pytest.raises(ValueError, match="decoder 'pil'"):
    llff.read_image(files["even_png_rgb"], decoder="pil")


def test_batch_raises_naming_a_refused_file(files, tmp_path):
  cmyk = str(tmp_path / "cmyk.jpg")
  Image.fromarray(_image(H, W, 3, 9)).convert("CMYK").save(cmyk,
                                                           format="JPEG")
  with pytest.raises(IOError, match=re.escape(cmyk) + ": .*"
                     + re.escape(cmyk) + ": 4-component"):
    native_loader.NativeImageLoader(2).decode(
        [files["even_png_rgb"], cmyk], H, W)


def test_threads_decode_together(files):
  """Python threads decode at once (ctypes lets the interpreter lock go)
  and each gets its own file's bytes."""
  names = [n for n in sorted(files) if n.startswith("odd61x93_")]
  want = {n: llff.read_image(files[n], decoder="numpy") for n in names}
  got, errors = {}, []

  def work(part):
    try:
      for _ in range(3):
        for n in part:
          got[n] = llff.read_image(files[n])
    except Exception as exc:  # surfaced below
      errors.append(exc)

  threads = [threading.Thread(target=work, args=(names[i::4],))
             for i in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  assert not errors
  for n in names:
    np.testing.assert_array_equal(got[n], want[n], err_msg=n)


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_scene_batches_equal_with_either_decoder(tmp_path, monkeypatch, fmt):
  h, w, frames = 37, 52, 9
  synthetic_scene.write_synthetic_scene(str(tmp_path), "s",
                                        num_frames=frames, height=h, width=w)
  if fmt == "jpeg":
    for path in sorted((tmp_path / "s" / "dense").glob("images*/*.png")):
      jpeg.write(str(path.with_suffix(".jpg")), png.read(str(path)))
      path.unlink()
  cfg = DynibarConfig(folder_path=str(tmp_path), train_scenes=["s"],
                      training_height=h, num_source_views=3, num_vv=2,
                      max_range=10, erosion_radius=2, mask_src_view=True)
  native = MonocularSceneData(cfg, "s")
  want = [native.sample_batch(np.random.RandomState(seed), 24, "uniform")
          for seed in range(2)]
  assert all(f.endswith(".jpg" if fmt == "jpeg" else ".png")
             for f in native.rgb_files)
  plain_read, plain_shape = llff.read_image, llff.read_image_shape
  monkeypatch.setattr(llff, "read_image",
                      lambda path: plain_read(path, decoder="numpy"))
  monkeypatch.setattr(llff, "read_image_shape",
                      lambda path: plain_shape(path, decoder="numpy"))
  numpy_data = MonocularSceneData(cfg, "s")
  for seed in range(2):
    got = numpy_data.sample_batch(np.random.RandomState(seed), 24, "uniform")
    assert set(got) == set(want[seed])
    for k in got:
      x, y = np.asarray(got[k]), np.asarray(want[seed][k])
      assert x.dtype == y.dtype, k
      np.testing.assert_array_equal(x, y, err_msg=k)


def test_host_build_is_apart_from_the_kernels(tmp_path, monkeypatch):
  """Editing the host source moves only its own library's hash; editing
  a kernel source moves only the kernels'."""
  csrc = tmp_path / "csrc"
  csrc.mkdir()
  for src in build.CSRC.iterdir():
    (csrc / src.name).write_bytes(src.read_bytes())
  monkeypatch.setattr(build, "CSRC", csrc)
  host, kernels = (build.host_library_path("image_loader"),
                   [build.library_path(n) for n in build.KERNEL_SOURCES])
  (csrc / "image_loader.cc").write_text(
      (csrc / "image_loader.cc").read_text() + "\n// edited\n")
  assert build.host_library_path("image_loader") != host
  assert [build.library_path(n) for n in build.KERNEL_SOURCES] == kernels
  host = build.host_library_path("image_loader")
  (csrc / "sample.cu").write_text((csrc / "sample.cu").read_text() + "\n")
  assert build.host_library_path("image_loader") == host
  assert build.library_path("sample") != kernels[0]


def test_host_build_raises_without_a_compiler(tmp_path, monkeypatch):
  monkeypatch.setattr(build, "HOST_DIR", tmp_path / "host")
  monkeypatch.setenv("CXX", "no-such-compiler-anywhere")
  with pytest.raises(RuntimeError, match="no-such-compiler-anywhere not "
                     "found"):
    build.build_host("image_loader")
  monkeypatch.setenv("CXX", "false")         # a compiler that fails
  with pytest.raises(RuntimeError, match="failed for image_loader.cc"):
    build.build_host("image_loader")
  assert not list((tmp_path / "host").glob("*.so"))


def test_host_build_runs_once_for_processes_starting_together(tmp_path,
                                                             monkeypatch):
  """Three builds at once (as xdist workers reach their first decode):
  the file lock lets one compile; the others find its library."""
  monkeypatch.setattr(build, "HOST_DIR", tmp_path / "host")
  errors = []

  def work():
    try:
      build.build_host("image_loader")
    except Exception as exc:  # surfaced below
      errors.append(exc)

  threads = [threading.Thread(target=work) for _ in range(3)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  assert not errors
  built = {p.name for p in (tmp_path / "host").iterdir()}
  assert built == {"image_loader.lock",
                   build.host_library_path("image_loader").name}
