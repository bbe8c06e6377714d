"""The port's Nvidia eval surface vs the JAX package and the image
libraries, on the CPU (JAX in f32, which runs no Pallas kernel).

  * ``eval/metrics.py``: masked PSNR / SSIM with 2-D and 3-D masks and
    with MSE 0, within 1e-12;
  * ``nvidia_static_pose_ids`` over 12-30 frames and every render index:
    equal;
  * ``data/resize.py``: ``resize_area`` equals ``cv2.INTER_AREA`` on
    uint8 (2x, 4x, 540x960 -> 288x512, odd sizes, the same size), and
    ``imread_color`` equals ``cv2.imread(...)[:, :, ::-1]`` on gray and
    colour PNGs and JPEGs; ``resize_nearest`` of the eval's 3-channel
    float mask equals ``cv2.INTER_NEAREST`` (these skip without cv2);
  * ``data/jpeg.py``'s encoder writes the bytes imageio writes (gray and
    4:2:0 colour, odd sizes, 288x512): byte-identical, reached in every
    case;
  * ``write_synthetic_nvidia_scene`` writes the JAX writer's files: arrays
    equal, PNGs decoded equal, JPEGs byte-identical;
  * ``NvidiaSceneData.eval_batch`` and ``sample_batch`` give the JAX
    dataset's arrays, with ``mask_static`` on and off: images and masks
    equal, cameras within 1e-6;
  * ``LPIPSNet`` with seeded weights in a reference-layout ``alex.pth`` /
    ``alexnet.pth`` pair read by both ``load_torch_lpips``: within 1e-5
    relative, with and without a mask; without weights None and NaN;
  * ``evaluate_scene`` on a 16x24 scene with the JAX weights carried over
    by ``load_jax_params``, ``mask_static`` on and off: every viewpoint's
    full, dynamic and static PSNR within 1e-3 dB, SSIM within 1e-5, and
    the same WARNING lines.

Three choices make that comparison mean something, each against a
tie that f32 rounding breaks either way in either package.  The fine
stage has 8 + 8 samples: the composite's ray mask needs more than 8
valid samples, so at 4 + 4 every prediction is dark and every metric 0 in
both packages.  The poses are moved off the writer's vertical line and
the frame is 18 of 24: the writer's cameras differ by a vertical
translation alone, so a ray through the first or last column projects
onto that column of every source, and at an early frame one source is
the target camera itself, so every border pixel does; the in-bounds test
there is a tie (``test_torch_port_render.test_frame_render`` leaves those
pixels out for the same reason), and a border pixel that sees one view
more or less differs by a large part of its rgb.  At frame 18 every
source is frame 12 or later, none is a target camera.  And the density
heads' bias is lowered by 2: on a nearly opaque ray a zero-weight bin's
pdf, 1e-5 over the weights' sum, sits on the importance sampler's 1e-5
floor (``sample_pdf``'s ``denom < 1e-5``), and the last fine sample
jumps a whole bin on a last-bit difference of the coarse weights.
Without the first there is nothing to compare; without either of the
others the comparison failed its PSNR bar (on a 32x48 scene).
"""

import os
import pathlib

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.data import nvidia as jnvidia
from dynibar_tpu.data import synthetic_scene as jscene
from dynibar_tpu.eval import lpips as jlpips
from dynibar_tpu.eval import metrics as jmetrics
from dynibar_tpu.eval import nvidia_eval as jeval
from dynibar_tpu.models.dynibar import FFModel as JFFModel
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data import jpeg, nvidia, png, synthetic_scene
from dynibar_tpu_torch.data.monocular import resize_nearest
from dynibar_tpu_torch.data.resize import imread_color, resize_area
from dynibar_tpu_torch.eval import lpips, metrics
from dynibar_tpu_torch.eval import nvidia_eval
from dynibar_tpu_torch.models.dynibar import FFModel
from dynibar_tpu_torch.utils import convert
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
EVAL_CONFIG = str(ROOT / "configs_nvidia" / "eval_balloon1_long.txt")
SCENE, FRAMES, H, W = "Balloon1", 12, 32, 48
# the evaluated scene, its size and frame (see above); one chunk a view
EVAL_FRAMES, EVAL_FRAME, EVAL_H, EVAL_W = 24, 18, 16, 24
# the render's knobs shared by the eval tests: 8 + 8 samples (see above)
SMALL = dict(training_height=EVAL_H, N_samples=8, N_importance=8,
             chunk_size=EVAL_H * EVAL_W, compute_dtype="float32")
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


def _image(h, w, channels, seed):
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[0:h, 0:w]
  base = [np.sin(xx / 7.0 + yy / 11.0) * 100, np.cos(xx / 5.0) * 90,
          np.sin(yy / 3.0) * 60]
  img = np.stack([128 + b for b in base[:channels]], -1)
  img = np.clip(img + rng.normal(0, 15, img.shape), 0, 255).astype(np.uint8)
  return img[..., 0] if channels == 1 else img


# ------------------------------------------------------------- metrics


def _pair(seed, shape=(24, 40, 3)):
  rng = np.random.RandomState(seed)
  a = rng.rand(*shape).astype(np.float32)
  return a, np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("mask_kind", ["2d", "3d", "ones", "mse0"])
def test_masked_metrics_match_jax(mask_kind):
  a, b = _pair(1)
  rng = np.random.RandomState(2)
  mask = {"2d": np.float32(rng.rand(24, 40) > 0.4),
          "3d": np.tile(np.float32(rng.rand(24, 40, 1) > 0.4), (1, 1, 3)),
          "ones": np.ones((24, 40, 3), np.float32),
          "mse0": np.ones((24, 40), np.float32)}[mask_kind]
  if mask_kind == "mse0":
    b = a.copy()
  # PSNR broadcasts the mask over the channels: a 2-D one gets its axis
  psnr_mask = mask[..., None] if mask.ndim == 2 else mask
  for fn, m in (("masked_psnr", psnr_mask), ("masked_ssim", mask)):
    got = getattr(metrics, fn)(a, b, m)
    want = getattr(jmetrics, fn)(a, b, m)
    assert abs(got - want) <= 1e-12, (fn, got, want)
  if mask_kind == "mse0":
    assert metrics.masked_psnr(a, b, psnr_mask) == 0.0
  assert abs(metrics.mse2psnr(0.01) - jmetrics.mse2psnr(0.01)) <= 1e-12


@pytest.mark.parametrize("num_frames", range(12, 31))
def test_static_pose_ids_match_jax(num_frames):
  for render_idx in range(num_frames):
    np.testing.assert_array_equal(
        nvidia.nvidia_static_pose_ids(render_idx, num_frames),
        jnvidia.nvidia_static_pose_ids(render_idx, num_frames))


# ------------------------------------------------------ OpenCV's reads


@pytest.mark.parametrize("src,dst", [((576, 1024), (288, 512)),
                                     ((128, 192), (32, 48)),
                                     ((540, 960), (288, 512)),
                                     ((37, 52), (17, 25)),
                                     ((288, 512), (288, 512))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_area_matches_cv2(src, dst, channels):
  cv2 = pytest.importorskip("cv2")
  img = np.random.RandomState(3).randint(
      0, 256, src + ((channels,) if channels > 1 else ())).astype(np.uint8)
  want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
  np.testing.assert_array_equal(resize_area(img, *dst), want)


@pytest.mark.parametrize("src,dst", [((48, 64), (32, 48)),
                                     ((288, 512), (288, 512))])
def test_resize_nearest_of_a_color_mask_matches_cv2(src, dst):
  cv2 = pytest.importorskip("cv2")
  rng = np.random.RandomState(4)
  mask = np.tile(np.float32(rng.rand(*src, 1) > 0.5), (1, 1, 3))
  want = cv2.resize(mask, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
  np.testing.assert_array_equal(resize_nearest(mask, *dst), want)


@pytest.mark.parametrize("ext,channels", [("png", 1), ("png", 3),
                                          ("png", 4), ("jpg", 1),
                                          ("jpg", 3)])
def test_imread_color_matches_cv2(tmp_path, ext, channels):
  cv2 = pytest.importorskip("cv2")
  img = _image(29, 43, min(channels, 3), channels)
  if channels == 4:
    img = np.concatenate([img, _image(29, 43, 1, 9)[..., None]], -1)
  path = str(tmp_path / f"a.{ext}")
  imageio.imwrite(path, img)
  want = cv2.imread(path)[:, :, ::-1]
  got = imread_color(path)
  assert got.shape == (29, 43, 3) and got.dtype == np.uint8
  np.testing.assert_array_equal(got, want)
  # the eval's ground-truth read and mask read
  np.testing.assert_array_equal(
      nvidia_eval.imread_resized(path, 17, 25),
      jeval._imread_resized(path, (25, 17)))
  np.testing.assert_array_equal(nvidia_eval.mask_resized(path, 17, 25),
                                jeval._mask_resized(path, (25, 17)))


# -------------------------------------------------------- JPEG writer


@pytest.mark.parametrize("shape", [(32, 48), (32, 48, 3), (37, 52),
                                   (37, 52, 3), (9, 17, 3), (1, 1, 3),
                                   (100, 3), (288, 512, 3)])
@pytest.mark.parametrize("content", ["smooth", "noise"])
def test_jpeg_encoder_writes_imageios_bytes(tmp_path, shape, content):
  """Byte-identical to imageio's file (PIL, libjpeg defaults: quality 75,
  4:2:0, islow DCT, standard Huffman tables)."""
  channels = shape[2] if len(shape) == 3 else 1
  img = (_image(shape[0], shape[1], channels, 5) if content == "smooth"
         else np.random.RandomState(6).randint(0, 256, shape).astype(
             np.uint8))
  path = str(tmp_path / "a.jpg")
  imageio.imwrite(path, img)
  with open(path, "rb") as fh:
    want = fh.read()
  assert jpeg.encode(img) == want
  mine = str(tmp_path / "b.jpg")
  jpeg.write(mine, img)
  np.testing.assert_array_equal(imageio.imread(mine), imageio.imread(path))


def test_jpeg_encoder_rejects_other_layouts():
  for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.float32)):
    with pytest.raises(ValueError, match="uint8"):
      jpeg.encode(bad)


# -------------------------------------------------------- the scene


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
  """The JAX writer's scene and the port's, side by side."""
  root = tmp_path_factory.mktemp("nvidia")
  jroot, proot = root / "jax", root / "port"
  jscene.write_synthetic_nvidia_scene(str(jroot), SCENE, FRAMES, H, W)
  synthetic_scene.write_synthetic_nvidia_scene(str(proot), SCENE, FRAMES, H,
                                               W)
  return jroot, proot


def generic_poses(root):
  """Give each frame of a written scene a pose off the writer's vertical
  line: a translation along the other image axis and a turn about the
  viewing axis, both growing with the frame index (see the module
  docstring)."""
  path = os.path.join(root, SCENE, "dense", "poses_bounds_cvd.npy")
  rows = np.load(path)
  for i, row in enumerate(rows):
    pose = row[:15].reshape(3, 5)
    t = 0.013 * i
    turn = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                     [0, 0, 1]])
    pose[:, :3] = pose[:, :3] @ turn
    pose[1, 3] += 0.05 * i
    row[:15] = pose.reshape(-1)
  np.save(path, rows)


@pytest.fixture(scope="module")
def eval_scenes(tmp_path_factory):
  """24-frame scenes, the JAX writer's and the port's (equal files), on
  generic poses."""
  root = tmp_path_factory.mktemp("nvidia24")
  jroot, proot = root / "jax", root / "port"
  jscene.write_synthetic_nvidia_scene(str(jroot), SCENE, EVAL_FRAMES,
                                      EVAL_H, EVAL_W)
  synthetic_scene.write_synthetic_nvidia_scene(str(proot), SCENE,
                                               EVAL_FRAMES, EVAL_H, EVAL_W)
  for r in (jroot, proot):
    generic_poses(r)
  return jroot, proot


def test_nvidia_scene_writer_matches_jax(scenes):
  jroot, proot = scenes
  jfiles = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                  if p.is_file())
  pfiles = sorted(p.relative_to(proot) for p in proot.rglob("*")
                  if p.is_file())
  assert jfiles == pfiles
  kinds = {".npy": 0, ".npz": 0, ".png": 0, ".jpg": 0}
  for rel in jfiles:
    a, b = str(jroot / rel), str(proot / rel)
    kinds[rel.suffix] += 1
    if rel.suffix == ".npy":
      np.testing.assert_array_equal(np.load(b), np.load(a))
    elif rel.suffix == ".npz":
      ja, pa = np.load(a), np.load(b)
      assert sorted(ja.files) == sorted(pa.files)
      for k in ja.files:
        np.testing.assert_array_equal(pa[k], ja[k])
    elif rel.suffix == ".png":
      np.testing.assert_array_equal(png.read(b), imageio.imread(a))
    else:
      with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fb.read() == fa.read(), rel
  assert kinds[".jpg"] == FRAMES * 12 and kinds[".png"] > FRAMES * 12


def _configs(root, **kw):
  over = dict(folder_path=str(root), **dict(SMALL, **kw))
  return (DynibarConfig.from_file(EVAL_CONFIG, **over),
          JConfig.from_file(EVAL_CONFIG, **over))


def _same_batch(got, want):
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    g = got[k]
    if "camera" in k:
      np.testing.assert_allclose(g, v, atol=1e-6, rtol=0, err_msg=k)
    else:
      np.testing.assert_array_equal(g, v, err_msg=k)
      assert np.asarray(g).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("mask_static", [True, False])
def test_eval_and_train_batches_match_jax(scenes, mask_static):
  jroot, _ = scenes
  cfg, jcfg = _configs(jroot, mask_static=mask_static, training_height=H)
  data = nvidia.NvidiaSceneData(cfg, SCENE, height=H)
  jdata = jnvidia.NvidiaSceneData(jcfg, SCENE, height=H)
  assert data.num_frames == jdata.num_frames == FRAMES
  np.testing.assert_array_equal(data.depth_range, jdata.depth_range)
  for frame, view in ((3, 0), (3, 11), (5, 4), (8, 8), (6, 2)):
    _same_batch(data.eval_batch(frame, view), jdata.eval_batch(frame, view))
    assert data.gt_image_path(frame, view) == jdata.gt_image_path(frame,
                                                                  view)
    assert data.mask_path(frame, view) == jdata.mask_path(frame, view)
  for idx in (2, 3, 7, 9):
    np.testing.assert_array_equal(data.coarse_mask(idx, (H, W)),
                                  jdata.coarse_mask(idx, (H, W)))
  # the FF training sampler, on the ff_train settings
  data = nvidia.NvidiaSceneData(cfg, SCENE, cfg.render_settings("ff_train"),
                                height=H)
  jdata = jnvidia.NvidiaSceneData(jcfg, SCENE,
                                  jcfg.render_settings("ff_train"), height=H)
  for seed in (0, 1, 2):
    data.set_epoch(seed)
    _same_batch(data.sample_batch(np.random.RandomState(seed), 64),
                jdata.sample_batch(np.random.RandomState(seed), 64))
    _same_batch(
        data.sample_batch(np.random.RandomState(seed), 32,
                          pixel_rng=np.random.RandomState(seed + 7)),
        jdata.sample_batch(np.random.RandomState(seed), 32,
                           pixel_rng=np.random.RandomState(seed + 7)))


# ------------------------------------------------------------- LPIPS


def _write_lpips_pair(folder, seed=0):
  """A reference-layout pair: the lpips package's lin weights
  (``lin{i}.model.1.weight``) and torchvision's AlexNet state_dict, with
  seeded weights scaled as a trained net's are."""
  g = torch.Generator().manual_seed(seed)
  alex, lins, cin = {}, {}, 3
  for i, (ti, (ch, k, _, _)) in enumerate(zip(lpips._CONV_IDX,
                                              lpips._ALEX_STAGES)):
    fan = cin * k * k
    alex[f"features.{ti}.weight"] = torch.randn(ch, cin, k, k,
                                                generator=g) / fan ** 0.5
    alex[f"features.{ti}.bias"] = 0.1 * torch.randn(ch, generator=g)
    lins[f"lin{i}.model.1.weight"] = torch.rand(1, ch, 1, 1, generator=g)
    cin = ch
  alex["classifier.1.weight"] = torch.randn(8, 4, generator=g)  # unread
  os.makedirs(folder, exist_ok=True)
  torch.save(lins, os.path.join(folder, "alex.pth"))
  torch.save(alex, os.path.join(folder, "alexnet.pth"))
  return str(folder)


@pytest.mark.parametrize("mask_kind", ["none", "2d", "3d"])
def test_lpips_matches_jax(tmp_path, mask_kind):
  folder = _write_lpips_pair(tmp_path / "lpips")
  got_metric = lpips.LPIPSMetric(folder, device="cpu")
  want_metric = jlpips.LPIPSMetric(folder)
  assert got_metric.available and want_metric.available
  a, b = _pair(8, (70, 90, 3))
  rng = np.random.RandomState(9)
  mask = {"none": None, "2d": np.float32(rng.rand(70, 90) > 0.3),
          "3d": np.tile(np.float32(rng.rand(70, 90, 1) > 0.3),
                        (1, 1, 3))}[mask_kind]
  got, want = got_metric(a, b, mask), want_metric(a, b, mask)
  assert want > 0
  assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_lpips_without_weights_is_none_and_nan(tmp_path):
  for folder in (None, str(tmp_path)):
    metric = lpips.LPIPSMetric(folder)
    assert not metric.available
    assert metric(*_pair(0)) is None
  acc = nvidia_eval.MetricAccumulator()
  acc.add(20.0, 0.5, None)
  table = acc.means()
  assert table["psnr"] == 20.0 and np.isnan(table["lpips"])


# ------------------------------------------------------ evaluate_scene


def jax_ff_params(jcfg, seed=0, num_frames=EVAL_FRAMES):
  """JAX FFModel params (numpy leaves) from a seed, with small nonzero
  motion coefficients so the displaced points are exercised, and the
  density heads' bias lowered by 2 so that no ray is nearly opaque (see
  the module docstring)."""
  jmodel = JFFModel(cfg=jcfg, num_frames=num_frames)
  params = jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(seed)))
  rng = np.random.RandomState(5)
  for name in ("motion_mlp", "motion_mlp_fine"):
    k = params[name]["coeff_kernel"]
    params[name]["coeff_kernel"] = (rng.randn(*k.shape) * 0.01).astype(
        np.float32)
  for name in ("net_coarse_st", "net_coarse_dy", "net_fine_st",
               "net_fine_dy"):
    head = params[name]["out_geometry_fc"]["dense_1"]
    head["bias"] = (head["bias"] - 2.0).astype(np.float32)
  return jmodel, params


class Recorder:
  """Every masked PSNR / SSIM an eval module computes, in order, and its
  log lines."""

  def __init__(self, monkeypatch, module):
    self.psnr, self.ssim, self.lines = [], [], []
    for name, out in (("masked_psnr", self.psnr),
                      ("masked_ssim", self.ssim)):
      fn = getattr(module, name)

      def wrapped(*a, fn=fn, out=out, **kw):
        out.append(fn(*a, **kw))
        return out[-1]

      monkeypatch.setattr(module, name, wrapped)

  def log(self, line):
    self.lines.append(line)

  def warnings(self):
    return [l for l in self.lines if l.startswith("WARNING")]


def check_metrics(got: Recorder, want: Recorder):
  """Per viewpoint and region (full, dynamic, static): PSNR within 1e-3
  dB, SSIM within 1e-5; the same WARNING lines; finite, non-trivial
  values."""
  assert len(got.psnr) == len(want.psnr) == 3 * 11
  np.testing.assert_allclose(got.psnr, want.psnr, atol=PSNR_TOL, rtol=0)
  np.testing.assert_allclose(got.ssim, want.ssim, atol=SSIM_TOL, rtol=0)
  assert np.isfinite(got.psnr).all() and min(got.psnr) > 1.0
  assert [l.split(":")[0] for l in got.warnings()] == [
      l.split(":")[0] for l in want.warnings()]


@pytest.mark.parametrize("mask_static", [True, False])
def test_evaluate_scene_matches_jax(eval_scenes, monkeypatch, mask_static):
  jroot, proot = eval_scenes
  cfg = _configs(proot, mask_static=mask_static)[0]
  jcfg = _configs(jroot, mask_static=mask_static)[1]
  jmodel, params = jax_ff_params(jcfg.render_settings("ff"))
  model = FFModel(cfg.render_settings("ff"), EVAL_FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  want, got = Recorder(monkeypatch, jeval), Recorder(monkeypatch,
                                                     nvidia_eval)
  frames = range(EVAL_FRAME, EVAL_FRAME + 1)
  want_res = jeval.evaluate_scene(
      jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), SCENE,
      frame_range=frames, log_fn=want.log)
  got_res = nvidia_eval.evaluate_scene(cfg, model, SCENE, frame_range=frames,
                                       log_fn=got.log, device="cpu")
  check_metrics(got, want)
  for region in ("full", "dynamic", "static"):
    assert abs(got_res[region]["psnr"] - want_res[region]["psnr"]) <= PSNR_TOL
    assert abs(got_res[region]["ssim"] - want_res[region]["ssim"]) <= SSIM_TOL
    assert np.isnan(got_res[region]["lpips"])
  assert sum(l.startswith(f"frame {EVAL_FRAME} cam") for l in got.lines) == 11
  assert got.lines[-1].startswith("FINAL")


def test_fine_static_sources_change_the_fine_maps_only():
  """encode_featmaps with other fine static sources (the eval's
  mask_static) leaves the coarse maps and the dynamic maps alone."""
  cfg = DynibarConfig(N_samples=4, N_importance=4).render_settings("ff")
  model = FFModel(cfg, FRAMES, device="cpu")
  rng = np.random.RandomState(0)
  src = torch.from_numpy(rng.rand(7, 16, 24, 3).astype(np.float32))
  st = torch.from_numpy(rng.rand(11, 16, 24, 3).astype(np.float32))
  masked = st * (torch.arange(24) < 12).float()[:, None]
  with torch.no_grad():
    c0, f0 = model.encode_featmaps(src, st)
    c1, f1 = model.encode_featmaps(src, st, fine_static_src_rgbs=masked)
    _, f2 = model.encode_featmaps(src, masked)
  for a, b in ((c0[0], c1[0]), (c0[2], c1[2]), (f0[0], f1[0]),
               (f1[2], f2[2])):
    torch.testing.assert_close(a, b, rtol=0, atol=0)
  assert not torch.equal(f0[2], f1[2])
