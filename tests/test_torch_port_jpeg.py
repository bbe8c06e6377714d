"""The port's JPEG decoder (data/jpeg.py) vs imageio, and a JPEG scene in
both packages, on the CPU.

The bar: every sample within 2 of 255 of imageio's decode and the mean
absolute difference at most 0.5 of 255.  (The decoder reproduces
libjpeg's integer inverse DCT, fancy upsampling and color tables, so it
usually meets the bar with no difference at all.)  Files are written by
PIL and OpenCV at several qualities and chroma subsamplings, with odd
sizes and restart markers, sequential and progressive; the kinds neither
package writes (lossless, arithmetic-coded, hierarchical, 12-bit, CMYK)
raise, naming the file.  Each decode and refusal case runs on both
decoders: data/jpeg.py ("numpy") and the C++ host decoder
(data/native_loader.py, "native"), which must also return data/jpeg.py's
bytes exactly and refuse with its message.  A monocular scene whose frames
are JPEGs (sequential or progressive) gives the JAX package's poses and
batches (rgb within the bar, everything else exactly).
"""

import io

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.data import llff as jllff
from dynibar_tpu.data.monocular import MonocularSceneData as JMono
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data import jpeg, llff, native_loader, synthetic_scene
from dynibar_tpu_torch.data.monocular import MonocularSceneData
from torch_port_threads import one_torch_thread  # noqa: F401

MAX_DIFF, MEAN_DIFF = 2, 0.5          # of 255
H, W, FRAMES = 37, 52, 9


def _image(h, w, channels, seed):
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[0:h, 0:w]
  base = [np.sin(xx / 7.0 + yy / 11.0) * 100, np.cos(xx / 5.0) * 90,
          np.sin(yy / 3.0) * 60]
  img = np.stack([128 + b for b in base[:channels]], -1)
  img = img + rng.normal(0, 15, img.shape)
  img = np.clip(img, 0, 255).astype(np.uint8)
  return img[..., 0] if channels == 1 else img


def _pil_jpeg(img, **kw) -> bytes:
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, format="JPEG", **kw)
  return buf.getvalue()


DECODERS = pytest.mark.parametrize("decoder", llff.DECODERS)


def _decode(data: bytes, decoder: str, tmp_path) -> np.ndarray:
  """JPEG bytes decoded by `decoder`; the native decoder reads a file and
  must return data/jpeg.py's bytes."""
  want = jpeg.decode(data)
  if decoder == "numpy":
    return want
  path = tmp_path / "frame.jpg"
  path.write_bytes(data)
  got = native_loader.decode_file(str(path))
  np.testing.assert_array_equal(got, want)
  assert got.dtype == want.dtype
  return got


def _read(path: str, decoder: str) -> np.ndarray:
  return (jpeg.read(path) if decoder == "numpy"
          else native_loader.decode_file(path))


def _check(got, want):
  assert got.shape == want.shape and got.dtype == np.uint8
  diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
  assert diff.max() <= MAX_DIFF and diff.mean() <= MEAN_DIFF, (
      diff.max(), diff.mean())


@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])    # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize("size", [(61, 93), (16, 16), (33, 8)])
@DECODERS
def test_decodes_what_pil_writes(quality, subsampling, size, decoder,
                                 tmp_path):
  img = _image(*size, 3, seed=quality + subsampling)
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, format="JPEG", quality=quality,
                            subsampling=subsampling)
  _check(_decode(buf.getvalue(), decoder, tmp_path),
         imageio.imread(io.BytesIO(buf.getvalue())))


@pytest.mark.parametrize("quality", [50, 90])
@DECODERS
def test_decodes_grayscale(quality, decoder, tmp_path):
  img = _image(45, 70, 1, seed=quality)
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, format="JPEG", quality=quality)
  got = _decode(buf.getvalue(), decoder, tmp_path)
  assert got.ndim == 2
  _check(got, imageio.imread(io.BytesIO(buf.getvalue())))


@pytest.mark.parametrize("interval", [1, 5, 16])
@DECODERS
def test_decodes_restart_markers(interval, decoder, tmp_path):
  img = _image(72, 101, 3, seed=interval)
  ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                       cv2.IMWRITE_JPEG_RST_INTERVAL,
                                       interval])
  data = enc.tobytes()
  assert ok and any(bytes([0xFF, 0xD0 + i]) in data for i in range(8))
  _check(_decode(data, decoder, tmp_path), imageio.imread(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])    # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize("size", [(61, 93), (16, 16), (33, 8)])
@DECODERS
def test_decodes_progressive(quality, subsampling, size, decoder, tmp_path):
  """Progressive files (SOF2: DC and AC first and refinement scans,
  spectral selection, EOB runs), as PIL writes them."""
  img = _image(*size, 3, seed=quality + subsampling + 7)
  data = _pil_jpeg(img, quality=quality, subsampling=subsampling,
                   progressive=True)
  assert b"\xff\xc2" in data
  _check(_decode(data, decoder, tmp_path), imageio.imread(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [50, 90])
@DECODERS
def test_decodes_progressive_grayscale(quality, decoder, tmp_path):
  img = _image(45, 70, 1, seed=quality + 3)
  data = _pil_jpeg(img, quality=quality, progressive=True)
  got = _decode(data, decoder, tmp_path)
  assert got.ndim == 2
  _check(got, imageio.imread(io.BytesIO(data)))


@pytest.mark.parametrize("encoder", ["pil", "cv2"])
@pytest.mark.parametrize("interval", [1, 5, 16])
@DECODERS
def test_decodes_progressive_restart_markers(encoder, interval, decoder,
                                             tmp_path):
  """Restart markers reset the DC predictors and the EOB runs."""
  img = _image(72, 101, 3, seed=interval + 11)
  if encoder == "pil":
    data = _pil_jpeg(img, quality=85, subsampling=2, progressive=True,
                     restart_marker_blocks=interval)
  else:
    ok, enc = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
    assert ok
    data = enc.tobytes()
  assert b"\xff\xc2" in data
  assert any(bytes([0xFF, 0xD0 + i]) in data for i in range(8))
  _check(_decode(data, decoder, tmp_path), imageio.imread(io.BytesIO(data)))


@DECODERS
def test_reads_files_and_refuses_progressive(tmp_path, decoder):
  """Files read from disk, sequential and progressive (Huffman, 8-bit),
  and their shapes from the frame header; refused are what is not a JPEG
  and the progressive kinds neither package writes (arithmetic-coded,
  12-bit).  Until the decoder learned SOF2 this test held every
  progressive file to a refusal; it keeps its name."""
  img = _image(40, 64, 3, seed=1)
  path = str(tmp_path / "frame.jpg")
  imageio.imwrite(path, img, quality=90)
  _check(_read(path, decoder), imageio.imread(path))
  assert jpeg.read_shape(path) == (40, 64, 3)
  assert llff.read_image_shape(path, decoder) == (40, 64, 3)
  prog = str(tmp_path / "prog.jpg")
  Image.fromarray(img).save(prog, format="JPEG", progressive=True)
  _check(_read(prog, decoder), imageio.imread(prog))
  assert jpeg.read_shape(prog) == (40, 64, 3)
  assert llff.read_image_shape(prog, decoder) == (40, 64, 3)
  gray = str(tmp_path / "gray.jpg")
  Image.fromarray(img[..., 0]).save(gray, format="JPEG", progressive=True)
  assert jpeg.read_shape(gray) == (40, 64)
  assert llff.read_image_shape(gray, decoder) == (40, 64)
  with pytest.raises(ValueError, match="not a JPEG"):
    jpeg.decode(b"\x89PNG\r\n\x1a\n")
  for marker, bits, kind in ((0xCA, 8, "arithmetic-coded"),
                             (0xC2, 12, "12-bit")):
    odd = tmp_path / f"prog_{marker:x}_{bits}.jpg"
    odd.write_bytes(_frame_header(marker, bits) + b"\xff\xd9")
    with pytest.raises(ValueError, match=f"{odd.name}: {kind}"):
      _read(str(odd), decoder)


def _frame_header(marker: int, bits: int = 8) -> bytes:
  """SOI and a one-component 8x8 frame header with the given SOF marker."""
  body = bytes([bits, 0, 8, 0, 8, 1, 1, 0x11, 0])
  return b"\xff\xd8\xff" + bytes([marker]) + (len(body) + 2).to_bytes(
      2, "big") + body


@pytest.mark.parametrize("marker,kind", [
    (0xC3, "lossless"), (0xC5, "hierarchical"), (0xC9, "arithmetic-coded"),
    (0xCA, "arithmetic-coded")])
@DECODERS
def test_refuses_what_neither_package_writes(tmp_path, marker, kind,
                                             decoder):
  path = tmp_path / "odd.jpg"
  path.write_bytes(_frame_header(marker) + b"\xff\xd9")
  with pytest.raises(ValueError, match=f"odd.jpg: {kind}"):
    _read(str(path), decoder)


@pytest.mark.parametrize("marker", [0xC1, 0xC2])
@DECODERS
def test_refuses_12_bit_samples(tmp_path, marker, decoder):
  path = tmp_path / "deep.jpg"
  path.write_bytes(_frame_header(marker, bits=12) + b"\xff\xd9")
  with pytest.raises(ValueError, match="deep.jpg: 12-bit"):
    _read(str(path), decoder)


@pytest.mark.parametrize("progressive", [False, True])
@DECODERS
def test_refuses_cmyk(tmp_path, progressive, decoder):
  path = str(tmp_path / "cmyk.jpg")
  Image.fromarray(_image(16, 24, 3, seed=5)).convert("CMYK").save(
      path, format="JPEG", progressive=progressive)
  with pytest.raises(ValueError, match="cmyk.jpg: 4-component"):
    _read(path, decoder)


def _jpeg_scene(tmp_path_factory, progressive):
  root = tmp_path_factory.mktemp("jpeg_scene")
  synthetic_scene.write_synthetic_scene(str(root), "s", num_frames=FRAMES,
                                        height=H, width=W)
  dense = root / "s" / "dense"
  frames = sorted(dense.glob("images*/*.png"))
  assert len(frames) >= 2 * FRAMES
  for png_path in frames:
    img = imageio.imread(png_path)
    Image.fromarray(img).save(png_path.with_suffix(".jpg"), format="JPEG",
                              quality=90, subsampling=2,
                              progressive=progressive)
    png_path.unlink()
  return root


@pytest.fixture(scope="module")
def jpeg_scene(tmp_path_factory):
  """A monocular scene whose frames are JPEGs (4:2:0, quality 90)."""
  return _jpeg_scene(tmp_path_factory, progressive=False)


@pytest.fixture(scope="module")
def progressive_scene(tmp_path_factory):
  """The same scene with progressive JPEG frames."""
  return _jpeg_scene(tmp_path_factory, progressive=True)


def _configs(root, cls):
  return cls(folder_path=str(root), train_scenes=["s"], training_height=H,
             num_source_views=3, num_vv=2, max_range=10, erosion_radius=2,
             mask_src_view=True)


def test_a_jpeg_scene_loads_as_in_the_jax_package(jpeg_scene):
  _loads_as_in_the_jax_package(jpeg_scene)


def test_a_progressive_scene_loads_as_in_the_jax_package(progressive_scene):
  first = sorted((progressive_scene / "s" / "dense").glob("images*/*.jpg"))
  assert b"\xff\xc2" in first[0].read_bytes()
  _loads_as_in_the_jax_package(progressive_scene)


def _loads_as_in_the_jax_package(jpeg_scene):
  dense = str(jpeg_scene / "s" / "dense")
  got = llff.load_scene_poses(dense, height=H, with_vv=True)
  want = jllff.load_scene_poses(dense, height=H, with_vv=True)
  assert set(got) == set(want)
  assert all(f.endswith(".jpg") for f in got["imgfiles"])
  for k in want:
    if k == "imgfiles":
      assert got[k] == want[k]
    else:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  jd = JMono(_configs(jpeg_scene, JConfig), "s")
  pd = MonocularSceneData(_configs(jpeg_scene, DynibarConfig), "s")
  for seed in range(2):
    a = pd.sample_batch(np.random.RandomState(seed), 24, "uniform")
    b = jd.sample_batch(np.random.RandomState(seed), 24, "uniform")
    assert set(a) == set(b)
    for k in b:
      x, y = np.asarray(a[k]), np.asarray(b[k])
      assert x.dtype == y.dtype and x.shape == y.shape, k
      if "rgb" in k:
        diff = np.abs(x.astype(np.float64) - y.astype(np.float64)) * 255
        assert diff.max() <= MAX_DIFF + 1e-3, k
        assert diff.mean() <= MEAN_DIFF, k
      else:
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_frames_decode_once(jpeg_scene, monkeypatch):
  """MonocularSceneData decodes each frame once and keeps it: its batches
  equal those of a dataset that decodes every frame on every read."""
  cfg = _configs(jpeg_scene, DynibarConfig)
  cached, fresh = (MonocularSceneData(cfg, "s") for _ in range(2))
  reads = []
  plain_read = llff.read_image
  monkeypatch.setattr(llff, "read_image",
                      lambda path: reads.append(path) or plain_read(path))
  for seed in range(3):
    before = len(reads)
    fresh._rgb8.clear()
    want = fresh.sample_batch(np.random.RandomState(seed), 24, "uniform")
    del reads[before:]
    got = cached.sample_batch(np.random.RandomState(seed), 24, "uniform")
    for k in want:
      np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                    err_msg=k)
  frames = [p for p in reads if p in cached.rgb_files]
  assert frames and len(frames) == len(set(frames))
