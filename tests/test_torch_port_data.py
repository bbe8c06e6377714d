"""The port's data path vs the JAX package and the image libraries, CPU.

  * ``data/png.py`` decodes what imageio writes (gray, gray+alpha, RGB,
    RGBA) and rows under each of the five PNG filters exactly, and
    round-trips what it writes;
  * ``utils/viz.py``'s numpy colormaps equal matplotlib's ``jet`` and
    ``gray``, and ``colorize_np`` / ``flow_to_image`` the JAX package's;
  * the scene writer writes the JAX writer's arrays; ``load_scene_poses``
    reads the same poses;
  * ``resize_nearest`` / ``erode`` equal ``cv2.resize(INTER_NEAREST)`` /
    ``cv2.erode`` at non-integer factors, with blobs on the border;
  * ``MonocularSceneData.sample_batch`` gives every array of the JAX
    dataset's batch for the same ``RandomState``, with dynamic masks
    eroded after a non-integer resize; the two pipelines yield the same
    first batches; a ``configs/*.txt`` file parses to the same values;
  * snapshots match exactly ``<name>_<digits>``.
All comparisons are exact (array_equal) unless a line says otherwise.
"""

import dataclasses
import io
import pathlib
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.data import llff as jllff
from dynibar_tpu.data import synthetic_scene as jscene
from dynibar_tpu.data.factory import MixtureDataset as JMixture
from dynibar_tpu.data.monocular import MonocularSceneData as JMono
from dynibar_tpu.data.pipeline import PrefetchPipeline as JPipeline
from dynibar_tpu.utils import viz as jviz
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data import llff, png, synthetic_scene
from dynibar_tpu_torch.data.factory import (MixtureDataset,
                                            create_training_dataset)
from dynibar_tpu_torch.data.monocular import (MonocularSceneData, _disk_kernel,
                                              erode, resize_nearest)
from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
from dynibar_tpu_torch.utils import checkpoints as ckpt
from dynibar_tpu_torch.utils import viz

ROOT = pathlib.Path(__file__).resolve().parents[1]
# 37 x 52 frames: 288 / 37 is not an integer, so the dynamic mask's
# erosion runs after a non-integer resize both ways
H, W, FRAMES = 37, 52, 9


def _image(shape, seed):
  rng = np.random.RandomState(seed)
  yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                       indexing="ij")
  img = (np.sin(xx / 5.0 + yy / 7.0) * 100 + 120).astype(np.uint8)
  if len(shape) == 3:
    img = np.stack([img + 9 * i for i in range(shape[2])], -1).astype(
        np.uint8)
  img[5:9, 3:20] = rng.randint(0, 256, img[5:9, 3:20].shape)
  return img


# ---------------------------------------------------------------- png


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 2), (37, 53, 3),
                                   (37, 53, 4)])
def test_png_decodes_what_imageio_writes(tmp_path, shape):
  img = _image(shape, 0)
  path = str(tmp_path / "a.png")
  imageio.imwrite(path, img)
  got = png.read(path)
  np.testing.assert_array_equal(got, imageio.imread(path))
  assert png.read_shape(path) == got.shape


def _filtered_png(img, kind):
  """A PNG whose every row carries filter `kind` (PNG spec, 9.2)."""
  h, w, c = img.shape
  rows = img.reshape(h, w * c).astype(np.int64)
  out = []
  for y in range(h):
    x = rows[y]
    up = rows[y - 1] if y else np.zeros_like(x)
    left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
    ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
    if kind == 0:
      f = x
    elif kind == 1:
      f = x - left
    elif kind == 2:
      f = x - up
    elif kind == 3:
      f = x - (left + up) // 2
    else:
      p = left + up - ul
      pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
      pred = np.where((pa <= pb) & (pa <= pc), left,
                      np.where(pb <= pc, up, ul))
      f = x - pred
    out.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())

  def chunk(k, body):
    return (struct.pack(">I", len(body)) + k + body
            + struct.pack(">I", zlib.crc32(k + body)))

  color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
  return (b"\x89PNG\r\n\x1a\n"
          + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
          + chunk(b"IDAT", zlib.compress(b"".join(out)))
          + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_row_filters(kind, channels):
  img = _image((11, 13, channels), kind)
  data = _filtered_png(img, kind)
  got = png.decode(data)
  np.testing.assert_array_equal(got.reshape(img.shape), img)
  np.testing.assert_array_equal(imageio.imread(io.BytesIO(data)), got)


@pytest.mark.parametrize("shape", [(20, 30), (20, 30, 3), (20, 30, 4)])
def test_png_round_trip(tmp_path, shape):
  img = _image(shape, 1)
  path = str(tmp_path / "b.png")
  png.write(path, img)
  np.testing.assert_array_equal(png.read(path), img)
  np.testing.assert_array_equal(imageio.imread(path), img)


def test_png_refuses_what_it_does_not_read():
  buf = io.BytesIO()
  imageio.imwrite(buf, np.zeros((4, 4), np.uint16), format="png")
  with pytest.raises(ValueError, match="bit depth 16"):
    png.decode(buf.getvalue())
  with pytest.raises(ValueError, match="uint8"):
    png.encode(np.zeros((4, 4), np.float32))


# ---------------------------------------------------------------- viz


@pytest.mark.parametrize("name", ["jet", "gray"])
def test_colormaps_match_matplotlib(name):
  import matplotlib
  x = np.linspace(0.0, 1.0, 1001)
  np.testing.assert_allclose(viz.apply_cmap(x, name),
                             matplotlib.colormaps[name](x)[:, :3],
                             atol=1e-12)


@pytest.mark.parametrize("name", ["jet", "gray"])
@pytest.mark.parametrize("kw", ["none", "range", "mask"])
def test_colorize_and_flow_wheel_match_the_jax_helpers(name, kw):
  rng = np.random.RandomState(3)
  x = rng.rand(23, 31) * 5
  args = {"none": {}, "range": {"value_range": (0.5, 4.0)},
          "mask": {"mask": x > 1.0}}[kw]
  np.testing.assert_array_equal(viz.colorize_np(x, name, **args),
                                jviz.colorize_np(x, name, **args))
  flow = rng.randn(9, 14, 2).astype(np.float32) * 3
  np.testing.assert_array_equal(viz.flow_to_image(flow),
                                jviz.flow_to_image(flow))


# ------------------------------------------------------------ scene files


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
  """The same scene from both writers; then both get the same dynamic
  masks, whose blobs touch the image border."""
  root = tmp_path_factory.mktemp("scenes")
  for side, writer in (("jax", jscene), ("port", synthetic_scene)):
    writer.write_synthetic_scene(str(root / side), "s", num_frames=FRAMES,
                                 height=H, width=W)
  rng = np.random.RandomState(4)
  for i in range(FRAMES):
    m = np.full((H, W), 255, np.uint8)              # 255 = static
    for cy, cx in ((0, rng.randint(W)), (rng.randint(H), W - 1),
                   (rng.randint(H), rng.randint(W))):
      yy, xx = np.ogrid[:H, :W]
      m[(yy - cy) ** 2 + (xx - cx) ** 2 < 30] = 0
    for side in ("jax", "port"):
      imageio.imwrite(str(root / side / "s" / "dense" / "dynamic_masks"
                          / f"{i}.png"), m)
  return root


def test_scene_writer_matches_the_jax_writer(tmp_path):
  jscene.write_synthetic_scene(str(tmp_path / "j"), "s", num_frames=7,
                               height=16, width=24)
  synthetic_scene.write_synthetic_scene(str(tmp_path / "p"), "s",
                                        num_frames=7, height=16, width=24)
  want = sorted(p.relative_to(tmp_path / "j")
                for p in (tmp_path / "j").rglob("*") if p.is_file())
  got = sorted(p.relative_to(tmp_path / "p")
               for p in (tmp_path / "p").rglob("*") if p.is_file())
  assert got == want and len(want) > 100
  for rel in want:
    a, b = tmp_path / "j" / rel, tmp_path / "p" / rel
    if rel.suffix == ".png":
      np.testing.assert_array_equal(png.read(str(b)), imageio.imread(a))
    elif rel.suffix == ".npy":
      np.testing.assert_array_equal(np.load(b), np.load(a))
    else:
      za, zb = np.load(a), np.load(b)
      assert za.files == zb.files
      for k in za.files:
        np.testing.assert_array_equal(zb[k], za[k])


def test_load_scene_poses_matches(scenes):
  dense = str(scenes / "port" / "s" / "dense")
  got = llff.load_scene_poses(dense, height=H, with_vv=True)
  want = jllff.load_scene_poses(dense, height=H, with_vv=True)
  assert set(got) == set(want)
  for k in want:
    if k == "imgfiles":
      assert got[k] == want[k]
    else:
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("src,dst", [((37, 52), (288, 405)),
                                     ((288, 405), (37, 52)),
                                     ((37, 52), (50, 70)), ((40, 60), (40, 60))])
def test_resize_nearest_matches_cv2(src, dst):
  img = np.random.RandomState(5).rand(*src, 3).astype(np.float32)
  for a in (img, img[..., 0]):
    np.testing.assert_array_equal(
        resize_nearest(a, *dst),
        cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_erode_matches_cv2_at_the_border(radius):
  m = (np.random.RandomState(radius).rand(40, 60) > 0.3).astype(np.float32)
  m[:, 0] = m[0, :] = m[:, -1] = 1.0               # blobs on the border
  got = erode(m, _disk_kernel(radius))
  want = cv2.erode(m, _disk_kernel(radius))
  np.testing.assert_array_equal(got, want)
  assert got[0].any() and got.dtype == want.dtype


def _configs(scenes, side, **kw):
  kw = dict(folder_path=str(scenes / side), train_scenes=["s"],
            training_height=H, num_source_views=3, num_vv=2, max_range=10,
            erosion_radius=2, mask_src_view=True, **kw)
  return (JConfig if side == "jax" else DynibarConfig)(**kw)


def _equal_batches(got, want):
  assert set(got) == set(want)
  for k in want:
    a, b = np.asarray(got[k]), np.asarray(want[k])
    assert a.dtype == b.dtype, k
    np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("epoch", [0, 160, 400])
def test_sample_batch_matches_the_jax_dataset(scenes, epoch):
  jd = JMono(_configs(scenes, "jax"), "s")
  pd = MonocularSceneData(_configs(scenes, "port"), "s")
  jd.set_epoch(epoch)
  pd.set_epoch(epoch)
  for seed in range(3):
    for mode in ("uniform", "center"):
      _equal_batches(pd.sample_batch(np.random.RandomState(seed), 24, mode),
                     jd.sample_batch(np.random.RandomState(seed), 24, mode))
  # the eroded mask differs from the raw one, on the border too
  raw = 1.0 - png.read(pd.rgb_files[4].replace(
      f"images_{W}x{H}/00004.png", "dynamic_masks/4.png")) / 255.0
  m = pd._load_mask(4, "dynamic", (H, W))
  assert (m < raw).any() and m.shape == (H, W)


def test_pipelines_yield_the_same_first_batches(scenes):
  jd = JMixture([JMono(_configs(scenes, "jax"), "s")], [1.0])
  pd = create_training_dataset(_configs(scenes, "port"))
  assert isinstance(pd, MixtureDataset)

  def first(pipe, n=3):
    with pipe:
      return [next(pipe) for _ in range(n)]

  want = first(JPipeline(lambda r: jd.sample_batch(r, 16), num_workers=1,
                         seed=3, device_put=False))
  got = first(PrefetchPipeline(lambda r, _: pd.sample_batch(r, 16),
                               num_workers=1, seed=3))
  for a, b in zip(got, want):
    _equal_batches(a, b)
  # on a device the consumer hands out tensors: floats f32, integers int64
  t = first(PrefetchPipeline(lambda r, _: pd.sample_batch(r, 16),
                             num_workers=1, seed=3,
                             device=torch.device("cpu")), 1)[0]
  assert t["ray_o"].dtype == torch.float32
  assert t["ref_frame_idx"].dtype == torch.int64
  np.testing.assert_array_equal(t["rgb"].numpy(), got[0]["rgb"])


def test_pipeline_surfaces_loader_errors():
  def bad(*_):
    raise FileNotFoundError("no frame")
  with PrefetchPipeline(bad, num_workers=1) as pipe:
    with pytest.raises(FileNotFoundError):
      next(pipe)


@pytest.mark.parametrize("name", ["train_example.txt", "train_kid-running.txt",
                                  "test_kid-running.txt"])
def test_config_files_parse_the_same(name):
  path = str(ROOT / "configs" / name)
  got, want = DynibarConfig.from_file(path), JConfig.from_file(path)
  for f in dataclasses.fields(got):
    if f.name != "seed":
      assert getattr(got, f.name) == getattr(want, f.name), f.name
  assert got.experiment_name() == want.experiment_name()
  assert got.out_folder() == want.out_folder()
  rs, jrs = got.render_settings("mono"), want.render_settings("mono")
  for f in dataclasses.fields(rs):
    assert getattr(rs, f.name) == getattr(jrs, f.name), f.name


# ---------------------------------------------------------- checkpoints


def test_snapshots_match_exactly(tmp_path):
  """model_no-vv_* never counts as a model_* snapshot, however its step
  sorts; pruning keeps the newest `keep` of one name only."""
  state = {"w": torch.arange(3.0)}
  for step in (4, 8, 12, 16):
    ckpt.save_checkpoint(str(tmp_path), step, state, keep=3)
  ckpt.save_checkpoint(str(tmp_path), 99, state, name="model_no-vv")
  names = sorted(p.name for p in tmp_path.iterdir())
  assert names == ["model_00000008.pt", "model_00000012.pt",
                   "model_00000016.pt", "model_no-vv_00000099.pt"]
  assert ckpt.latest_checkpoint(str(tmp_path)).endswith("model_00000016.pt")
  payload, step = ckpt.resume_from(str(tmp_path))
  assert step == 16 and torch.equal(payload["model"]["w"], state["w"])
  assert ckpt.resume_from(str(tmp_path), no_reload=True) == (None, 0)
  explicit = str(tmp_path / "model_00000008.pt")
  assert ckpt.resume_from(str(tmp_path), ckpt_path=explicit)[1] == 8
  assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
