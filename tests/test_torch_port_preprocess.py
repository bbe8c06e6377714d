"""The port's scene preprocessing against the JAX package and OpenCV, on
the CPU:

  * ``llff.render_vv_wander_paths`` equals the JAX function exactly;
  * ``resize_area`` equals ``cv2.resize(INTER_AREA)`` on 1-, 3- and
    4-channel uint8 (an enlargement, a mixed-axis case, a whole-ratio and
    a non-whole shrink); ``resize_linear`` equals ``INTER_LINEAR`` on f32
    within rtol 1e-6, and exactly with OpenCV's IPP path off;
  * ``sobel_alpha`` within 1e-6, ``_disk1_erosion`` exactly;
  * ``softmax_splat`` on CPU tensors against the JAX splat (rgb within
    2e-3 on the 0-255 scale, alpha within 1e-5, zeros where no source
    pixel lands), ``forward_warp_rgbd`` on one 32×48 frame likewise;
  * both CLIs end to end against the JAX CLIs on copies of one 4-frame
    scene (36×48 frames enlarged to 72×96, 4 virtual views): every array
    at its bar, the resized frames equal, the virtual views equal except
    at pixels shown to be ties (under 0.1% of them);
  * ``render_source_vv`` without ``--device cpu`` raises without CUDA.

OpenCV is the oracle here only: the port never imports it.
"""

import shutil
import sys

import cv2
import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.cli import render_source_vv as jvv
from dynibar_tpu.cli import save_monocular_cameras as jsave
from dynibar_tpu.data import llff as jllff
from dynibar_tpu.ops import splat as jsplat
from dynibar_tpu_torch.cli import render_source_vv as pvv
from dynibar_tpu_torch.cli import save_monocular_cameras as psave
from dynibar_tpu_torch.data import llff, png
from dynibar_tpu_torch.data.resize import resize_area, resize_linear
from dynibar_tpu_torch.data.synthetic_scene import ConsistentScene
from dynibar_tpu_torch.ops.splat import softmax_splat
from torch_port_threads import one_torch_thread  # noqa: F401

FRAMES, H0, W0, HEIGHT, WIDTH, NUM_VV = 4, 36, 48, 72, 96, 4


def test_render_vv_wander_paths_equal_jax():
  rng = np.random.RandomState(0)
  for num_samples in (2, 4):
    c2w = np.concatenate([rng.randn(3, 4), [[288.0], [512.0], [358.4]]], 1)
    np.testing.assert_array_equal(
        llff.render_vv_wander_paths(c2w, 1.7, num_samples),
        jllff.render_vv_wander_paths(c2w, 1.7, num_samples))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("src,dst", [((72, 96), (288, 384)),
                                     ((40, 90), (60, 64)),
                                     ((96, 128), (48, 64)),
                                     ((135, 240), (36, 64))],
                         ids=["enlarge", "mixed", "whole", "non-whole"])
def test_resize_area_matches_cv2(src, dst, channels):
  rng = np.random.RandomState(channels)
  img = rng.randint(0, 256, src + (channels,), dtype=np.uint8)
  if channels == 1:
    img = img[..., 0]
  want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
  np.testing.assert_array_equal(resize_area(img, *dst), want)


@pytest.mark.parametrize("src,dst", [((144, 256), (288, 512)),
                                     ((36, 48), (72, 96)),
                                     ((64, 96), (32, 48)),
                                     ((40, 90), (60, 64)),
                                     ((50, 70), (23, 31))])
def test_resize_linear_matches_cv2(src, dst):
  img = (np.random.RandomState(1).rand(*src) * 10 + 0.1).astype(np.float32)
  want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
  got = resize_linear(img, *dst)
  assert got.dtype == np.float32
  if min(np.subtract(dst, src)) >= 0 or (2 * dst[0], 2 * dst[1]) == src:
    # an enlargement (the disparity's path) and the 2x shrink; where an
    # axis shrinks otherwise, OpenCV's IPP code differs from its own by up
    # to 2e-5 relative
    np.testing.assert_allclose(got, want, rtol=1e-6)
  use_ipp = cv2.ipp.useIPP()
  cv2.ipp.setUseIPP(False)
  try:
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
  finally:
    cv2.ipp.setUseIPP(use_ipp)
  np.testing.assert_array_equal(got, want)


def test_sobel_alpha_and_erosion_match_jax():
  rng = np.random.RandomState(2)
  for shape in ((32, 48), (7, 5)):
    d = (rng.rand(*shape) * 0.4 + 0.2).astype(np.float32)
    d[:, shape[1] // 2:] += 0.3                 # a depth edge
    np.testing.assert_allclose(pvv.sobel_alpha(d), jvv.sobel_alpha(d),
                               rtol=0, atol=1e-6)
    m = rng.rand(*shape) > 0.3
    np.testing.assert_array_equal(pvv._disk1_erosion(m),
                                  jvv._disk1_erosion(m))


def test_softmax_splat_matches_jax():
  rng = np.random.RandomState(3)
  h, w = 32, 48
  vals = (rng.rand(h, w, 4) * [255, 255, 255, 1]).astype(np.float32)
  flow = (rng.randn(h, w, 2) * 4).astype(np.float32)
  flow[:6] += 80.0                              # targets off the image
  flow[:, :8, 0] += 9.5                         # leaves target pixels empty
  imp = (rng.rand(h, w) * 20 - 10).astype(np.float32)
  want = np.asarray(jsplat.softmax_splat_jit(
      jnp.asarray(vals), jnp.asarray(flow), jnp.asarray(imp)))
  got = softmax_splat(torch.from_numpy(vals), torch.from_numpy(flow),
                      torch.from_numpy(imp)).numpy()
  empty = (want == 0).all(-1)
  assert 20 < empty.sum() < h * w // 2
  np.testing.assert_array_equal((got == 0).all(-1), empty)
  np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=0, atol=2e-3)
  np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=0, atol=1e-5)


def test_forward_warp_rgbd_matches_jax():
  h, w = 32, 48
  scene = ConsistentScene(num_frames=4, height=h, width=w)
  rgb, depth, _ = scene.render(scene.c2w(1), 1.0)
  rgb255 = (rgb * 255).astype(np.uint8).astype(np.float32)
  disp = (1.0 / depth).astype(np.float32)
  alpha = pvv.sobel_alpha((depth / 10.0).astype(np.float32))
  k = np.array([[scene.f, 0, w / 2.0], [0, scene.f, h / 2.0], [0, 0, 1.0]])
  dst = scene.c2w(1)
  dst[:3, 3] += [0.05, -0.04, 0.03]
  want = jvv.forward_warp_rgbd(rgb255, alpha, disp, k, scene.c2w(1), dst)
  got = pvv.forward_warp_rgbd(rgb255, alpha, disp, k, scene.c2w(1), dst,
                              device="cpu")
  assert (want[1] > 0.5).mean() > 0.5
  np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-3)
  np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def _write_inputs(dense, cvd):
  """A dynamic-video-depth output in the optimizer's layout over the
  analytic scene: 36×48 frames, 18×24 depth, one npz per frame, K and
  the pose in each of the layouts the CLI accepts."""
  (dense / "images").mkdir(parents=True)
  cvd.mkdir()
  frames = ConsistentScene(FRAMES, H0, W0)
  small = ConsistentScene(FRAMES, H0 // 2, W0 // 2)
  for i in range(FRAMES):
    rgb, _, _ = frames.render(frames.c2w(i), float(i))
    png.write(str(dense / "images" / f"{i:05d}.png"),
              (rgb * 255).astype(np.uint8))
    _, depth, _ = small.render(small.c2w(i), float(i))
    k = np.array([[small.f, 0, small.w / 2.0],
                  [0, small.f * 1.002, small.h / 2.0], [0, 0, 1.0]])
    c2w = frames.c2w(i)
    c2w[:3, :3] = cv2.Rodrigues(np.array([0.02 * i, -0.03, 0.01]))[0]
    arrays = {"depth": depth[None, None]}
    if i == 1:                                   # [fx, fy, cx, cy]
      arrays["intrinsics"] = k[[0, 1, 0, 1], [0, 1, 2, 2]]
    else:                                        # transposed unless frame 2
      arrays["K"] = (k if i == 2 else k.T)[None, None, None]
    arrays["pose_c2w" if i == 3 else "cam_c2w"] = c2w[None]
    np.savez(cvd / f"batch{i:04d}.npz", **arrays)


def _run_jax(monkeypatch, module, args):
  monkeypatch.setattr(sys, "argv", [module.__name__] + args)
  module.main()


def test_clis_match_jax(tmp_path, monkeypatch):
  jroot, proot = tmp_path / "jax", tmp_path / "port"
  _write_inputs(jroot / "dense", jroot / "cvd")
  shutil.copytree(jroot, proot)
  jd, pd = jroot / "dense", proot / "dense"
  _run_jax(monkeypatch, jsave, ["--data_path", str(jd), "--cvd_path",
                                str(jroot / "cvd"), "--height", str(HEIGHT)])
  res = psave.main(["--data_path", str(pd), "--cvd_path", str(proot / "cvd"),
                    "--height", str(HEIGHT)])
  assert res["frames"] == FRAMES
  np.testing.assert_allclose(np.load(pd / "poses_bounds_cvd.npy"),
                             np.load(jd / "poses_bounds_cvd.npy"),
                             rtol=1e-12, atol=0)
  wdir = f"images_{WIDTH}x{HEIGHT}"
  for i in range(FRAMES):
    name = f"{i:05d}"
    np.testing.assert_allclose(np.load(pd / "disp" / f"{name}.npy"),
                               np.load(jd / "disp" / f"{name}.npy"),
                               rtol=1e-6)
    np.testing.assert_array_equal(png.read(str(pd / wdir / f"{name}.png")),
                                  imageio.imread(jd / wdir / f"{name}.png"))

  _run_jax(monkeypatch, jvv, ["--data_path", str(jd), "--height",
                              str(HEIGHT), "--num_vv", str(NUM_VV)])
  out = pvv.main(["--data_path", str(pd), "--height", str(HEIGHT),
                  "--num_vv", str(NUM_VV), "--device", "cpu"])
  assert (out["frames"], out["views"]) == (FRAMES, NUM_VV)
  assert out["timer"].counts["splat"] == FRAMES * NUM_VV
  poses_j = np.load(jd / "source_vv_poses.npy")
  assert poses_j.shape == (NUM_VV, 3, 4, FRAMES)
  assert poses_j.dtype == np.float32
  np.testing.assert_allclose(np.load(pd / "source_vv_poses.npy"), poses_j,
                             rtol=0, atol=1e-6)

  # the views: each package's warp recomputed from its own files, which
  # reproduces its PNGs, and the port's splat again in f64.  The views may
  # differ only at ties: JAX's alpha within 1e-5 of the 0.5 threshold
  # (spread by the erosion), or a value within 1e-3 of a truncation step
  # with the two packages on either side.  A tie is exact where the f64
  # splat lies on the step: 2x-replicated sources give many targets
  # contributors of one colour, whose f32 average falls either side of it
  # in either package; the other ties stay under 0.1% of the pixels.
  splat64 = []

  def recording_splat(values, flow, importance):
    splat64.append(softmax_splat(values.double(), flow.double(),
                                 importance.double()).numpy())
    return softmax_splat(values, flow, importance)

  vdir = f"source_virtual_views_{WIDTH}x{HEIGHT}"
  warps = {}
  for root, mod, kw in ((jd, jvv, {}), (pd, pvv, {"device": "cpu"})):
    if mod is pvv:
      monkeypatch.setattr(pvv, "softmax_splat", recording_splat)
    rows = np.load(root / "poses_bounds_cvd.npy")
    poses = rows[:, :-2].reshape(-1, 3, 5)
    bd_scale = float(rows[:, -2].min()) * 0.75
    warps[mod] = []
    for i in range(FRAMES):
      rgb = png.read(str(root / wdir / f"{i:05d}.png")).astype(np.float32)
      disp = np.load(root / "disp" / f"{i:05d}.npy")
      f = poses[i, 2, 4]
      k = np.array([[f, 0, WIDTH / 2.0], [0, f, HEIGHT / 2.0], [0, 0, 1.0]])
      alpha = mod.sobel_alpha((1.0 / np.maximum(disp, 1e-8) / 10.0
                               ).astype(np.float32))
      vv = llff.render_vv_wander_paths(poses[i], bd_scale, NUM_VV // 2)
      for v in range(NUM_VV):
        rgb_out, a_out = mod.forward_warp_rgbd(
            rgb, alpha, disp, k, psave.llff_from_opencv(poses[i, :, :4]),
            psave.llff_from_opencv(vv[v]), **kw)
        value = np.clip(rgb_out / 255.0, 0.0, 1.0) * 255
        mask = pvv._disk1_erosion(a_out > 0.5)
        written = imageio.imread(root / vdir / f"{i:05d}" / f"{v:02d}.png")
        np.testing.assert_array_equal(
            written, (np.clip(value / 255 * mask[..., None], 0, 1) * 255
                      ).astype(np.uint8))
        warps[mod].append((value, a_out, written))
  assert len(splat64) == FRAMES * NUM_VV
  cross = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)
  exact_ties = ties = total = 0
  for (vj, aj, pngj), (vp, _, pngp), out64 in zip(warps[jvv], warps[pvv],
                                                   splat64):
    alpha_tie = cv2.dilate((np.abs(aj - 0.5) < 1e-5).astype(np.uint8),
                           cross).astype(bool)
    straddle = ((np.floor(vj) != np.floor(vp))
                & (np.abs(vj - np.rint(vj)) < 1e-3))
    v64 = np.clip(out64[..., :3] / 255.0, 0.0, 1.0) * 255
    exact = (straddle & (np.abs(v64 - np.rint(v64)) < 1e-6)).any(-1)
    tie = alpha_tie | straddle.any(-1)
    np.testing.assert_array_equal(pngp[~tie], pngj[~tie])
    exact_ties += exact.sum()
    ties += (tie & ~exact).sum()
    total += tie.size
  assert ties < 1e-3 * total, (ties, exact_ties, total)


def test_render_source_vv_needs_cuda_or_cpu(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    pvv.main(["--data_path", str(tmp_path)])
