"""The port's core/ (cameras, posenc, sampling, motion, projection,
composite) vs dynibar_tpu.core on identical numpy inputs, f32, CPU.

Tolerance: atol 1e-5 (f32 rounding of the same arithmetic in another
order), relative where a quantity scales with depth (z up to 30).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynibar_tpu.core import cameras as jcam
from dynibar_tpu.core import composite as jcomp
from dynibar_tpu.core import motion as jmotion
from dynibar_tpu.core import posenc as jposenc
from dynibar_tpu.core import projection as jproj
from dynibar_tpu.core import sampling as jsampling
from dynibar_tpu.ops.grid_sample import bilinear_sample_views
from dynibar_tpu_torch.core import cameras as cam
from dynibar_tpu_torch.core import composite as comp
from dynibar_tpu_torch.core import motion
from dynibar_tpu_torch.core import posenc
from dynibar_tpu_torch.core import projection as proj
from dynibar_tpu_torch.core import sampling
from dynibar_tpu_torch.data.ray_batch import synthetic_poses
from dynibar_tpu_torch.ops.sample import sample_views

R, S, V = 32, 8, 4
H, W = 32, 48
ATOL = 1e-5


def _t(a):
  return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=0.0):
  np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                        else got, np.float32),
                             np.asarray(want, np.float32), atol=atol,
                             rtol=rtol)


def _cameras(n, seed=0):
  poses = synthetic_poses(n + 1, seed)
  k = cam.intrinsics_from_hwf(H, W, 0.9 * W)
  return np.stack([cam.make_camera(H, W, k, poses[i]) for i in range(n + 1)])


def _rays(seed=0):
  rng = np.random.RandomState(seed)
  ray_o = (rng.randn(R, 3) * 0.1).astype(np.float32)
  ray_d = np.concatenate([rng.randn(R, 2) * 0.2, np.ones((R, 1))],
                         -1).astype(np.float32)
  return ray_o, ray_d, np.array([1.8, 30.0], np.float32)


# ---------------------------------------------------------------- cameras


def test_camera_codec_and_pose_inverse():
  cams = _cameras(V)
  k = cam.intrinsics_from_hwf(H, W, 40.0)
  np.testing.assert_array_equal(k, jcam.intrinsics_from_hwf(H, W, 40.0))
  np.testing.assert_array_equal(cam.make_camera(H, W, k, np.eye(4)),
                                jcam.make_camera(H, W, k, np.eye(4)))
  for got, want in zip(cam.split_camera(_t(cams)),
                       jcam.split_camera(jnp.asarray(cams))):
    _close(got, want, atol=0)
  c2w = cams[:, 18:].reshape(-1, 4, 4)
  _close(cam.invert_pose(_t(c2w)), jcam.invert_pose(jnp.asarray(c2w)))


def test_pixel_rays():
  cams = _cameras(1)
  _, _, k, c2w = jcam.split_camera(jnp.asarray(cams[0]))
  want = jcam.pixel_rays(H, W, k, c2w, stride=2)
  got = cam.pixel_rays(H, W, _t(np.asarray(k)), _t(np.asarray(c2w)),
                       stride=2)
  for g, wnt in zip(got, want):
    _close(g, wnt)


# ----------------------------------------------------------------- posenc


@pytest.mark.parametrize("max_freq,n_freq,linspace",
                         [(5, 5, False), (10, 10, False), (16, 16, True)])
def test_periodic_embed(max_freq, n_freq, linspace):
  x = np.random.RandomState(1).randn(R, S, 3).astype(np.float32)
  _close(posenc.periodic_embed(_t(x), max_freq, n_freq, linspace),
         jposenc.periodic_embed(jnp.asarray(x), max_freq, n_freq, linspace),
         atol=2e-5)


def test_sample_axis_posenc():
  np.testing.assert_array_equal(posenc.sample_axis_posenc(128, 64),
                                jposenc.sample_axis_posenc(128, 64))


# --------------------------------------------------------------- sampling


@pytest.mark.parametrize("inv_uniform", [True, False])
def test_sample_along_ray_det(inv_uniform):
  ray_o, ray_d, dr = _rays()
  want = jsampling.sample_along_ray(jnp.asarray(ray_o), jnp.asarray(ray_d),
                                    jnp.asarray(dr), S, inv_uniform, True)
  got = sampling.sample_along_ray(_t(ray_o), _t(ray_d), _t(dr), S,
                                  inv_uniform, True)
  for g, w in zip(got, want):
    _close(g, w, rtol=1e-6)


@pytest.mark.parametrize("inv_uniform", [True, False])
def test_sample_along_ray_stratified(inv_uniform):
  """The JAX side draws from its key; the port gets the same uniforms."""
  ray_o, ray_d, dr = _rays()
  key = jax.random.PRNGKey(3)
  want = jsampling.sample_along_ray(jnp.asarray(ray_o), jnp.asarray(ray_d),
                                    jnp.asarray(dr), S, inv_uniform, False,
                                    rng=key)
  t_rand = np.asarray(jax.random.uniform(key, (R, S), dtype=jnp.float32))
  got = sampling.sample_along_ray(_t(ray_o), _t(ray_d), _t(dr), S,
                                  inv_uniform, False, t_rand=_t(t_rand))
  for g, w in zip(got, want):
    _close(g, w, rtol=1e-6)


def _coarse_weights(seed=4):
  # every bin keeps some mass: the inverse CDF divides by a bin's pdf, so
  # a near-empty bin (pdf ~1e-5) turns 1e-8 cumsum rounding into a visible
  # shift of the sample that lands on its edge
  w = np.random.RandomState(seed).rand(R, S).astype(np.float32) + 0.1
  return w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("inv_uniform", [True, False])
def test_importance_resample_z(det, inv_uniform):
  ray_o, ray_d, dr = _rays()
  _, z, _ = jsampling.sample_along_ray(jnp.asarray(ray_o), jnp.asarray(ray_d),
                                       jnp.asarray(dr), S, inv_uniform, True)
  wts = _coarse_weights()
  key = None if det else jax.random.PRNGKey(7)
  want = jsampling.importance_resample_z(z, jnp.asarray(wts), 6, inv_uniform,
                                         det, rng=key)
  u = None if det else _t(np.asarray(jax.random.uniform(
      key, (R, 6), dtype=jnp.float32)))
  got = sampling.importance_resample_z(_t(np.asarray(z)), _t(wts), 6,
                                       inv_uniform, det, u=u)
  _close(got, want, rtol=1e-5)
  _close(sampling.z_to_s(got, 1.8, 30.0),
         jsampling.z_to_s(want, 1.8, 30.0), atol=1e-5)


def test_sample_pdf_matches():
  bins = np.sort(np.random.RandomState(5).rand(R, S + 1).astype(np.float32),
                 axis=-1)
  wts = _coarse_weights()
  want = jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(wts), 16, True)
  _close(sampling.sample_pdf(_t(bins), _t(wts), 16, True), want)


# ----------------------------------------------------------------- motion


def _traj(seed=6):
  rng = np.random.RandomState(seed)
  coeff = (rng.randn(R, S, 18) * 0.1).astype(np.float32)
  basis = motion.init_dct_basis(6, 24)
  return coeff, basis


def test_dct_basis_and_tail():
  np.testing.assert_array_equal(motion.init_dct_basis(6, 48),
                                jmotion.init_dct_basis(6, 48))
  coeff, _ = _traj()
  _close(motion.zero_tail_coeffs(_t(coeff), 20 if S > 20 else S),
         jmotion.zero_tail_coeffs(jnp.asarray(coeff), S), atol=0)


@pytest.mark.parametrize("frame_idx", [1, 10, 23])
def test_trajectory_window(frame_idx):
  """Basis rows clamp one by one at the sequence ends."""
  coeff, basis = _traj()
  win = motion.basis_window(_t(basis), torch.tensor(frame_idx), 3)
  jwin = jmotion.basis_window(jnp.asarray(basis), jnp.int32(frame_idx), 3)
  _close(win, jwin, atol=0)
  traj = motion.traj_points_window(_t(coeff), win)
  jtraj = jmotion.traj_points_window(jnp.asarray(coeff), jwin)
  _close(traj, jtraj)
  pts = np.random.RandomState(8).randn(R, S, 3).astype(np.float32)
  off = np.array([0, 2, 3, 6], np.int32)
  _close(motion.displaced_points(_t(pts), traj, _t(off), 3),
         jmotion.displaced_points(jnp.asarray(pts), jtraj, jnp.asarray(off),
                                  3))
  wts = _coarse_weights()
  _close(motion.expected_scene_flow(_t(wts), traj, 2, 3),
         jmotion.expected_scene_flow(jnp.asarray(wts), jtraj, 2, 3))


# ------------------------------------------------------------- projection


def _points(seed=9):
  ray_o, ray_d, dr = _rays(seed)
  pts, _, _ = sampling.sample_along_ray(_t(ray_o), _t(ray_d), _t(dr), S,
                                        True, True)
  disp = torch.from_numpy(
      np.random.RandomState(seed).randn(V, R, S, 3).astype(np.float32) * 0.05)
  return pts, pts[None] + disp


def test_project_points_and_masks():
  cams = _cameras(V)
  _, xyz = _points()
  pix, front = proj.project_points(xyz, _t(cams[1:]))
  jpix, jfront = jproj.project_points(jnp.asarray(xyz.numpy()),
                                      jnp.asarray(cams[1:]))
  _close(pix, jpix, atol=1e-3, rtol=1e-5)   # pixels: up to ~1e3 px
  np.testing.assert_array_equal(front.numpy(), np.asarray(jfront))
  np.testing.assert_array_equal(
      proj.inbound_mask(pix, H, W).numpy(),
      np.asarray(jproj.inbound_mask(jnp.asarray(pix.numpy()), H, W)))


def test_ray_angle_and_plucker():
  cams = _cameras(V)
  pts, xyz = _points()
  jpts, jxyz = jnp.asarray(pts.numpy()), jnp.asarray(xyz.numpy())
  _close(proj.ray_angle_features(pts, xyz, _t(cams[0]), _t(cams[1:])),
         jproj.ray_angle_features(jpts, jxyz, jnp.asarray(cams[0]),
                                  jnp.asarray(cams[1:])))
  ray_o, ray_d, _ = _rays(9)
  _close(proj.ref_plucker(_t(ray_o), _t(ray_d)),
         jproj.ref_plucker(jnp.asarray(ray_o), jnp.asarray(ray_d)))
  _close(proj.src_plucker(pts, _t(cams[1:])),
         jproj.src_plucker(jpts, jnp.asarray(cams[1:])))


def test_compute_with_motions_exact_gather():
  cams = _cameras(V)
  pts, xyz = _points()
  rng = np.random.RandomState(10)
  imgs = rng.rand(V, H, W, 3).astype(np.float32)
  feats = rng.randn(V, H // 4, W // 4, 5).astype(np.float32)
  valid = np.array([1, 1, 0, 1], np.float32)
  got = proj.compute_with_motions(pts, xyz, _t(cams[0]), _t(imgs),
                                  _t(cams[1:]), _t(feats), _t(valid),
                                  sample_views)
  want = jproj.compute_with_motions(
      jnp.asarray(pts.numpy()), jnp.asarray(xyz.numpy()),
      jnp.asarray(cams[0]), jnp.asarray(imgs), jnp.asarray(cams[1:]),
      jnp.asarray(feats), jnp.asarray(valid))
  assert float(want[2].mean()) > 0.2     # enough in-image samples
  for g, w in zip(got, want):
    _close(g, w, atol=2e-5)


def test_exact_gather_is_bilinear_sample_views():
  rng = np.random.RandomState(11)
  imgs = rng.rand(2, 9, 13, 4).astype(np.float32)
  grid = (rng.rand(2, 5, 6, 2) * 2.4 - 1.2).astype(np.float32)
  want = bilinear_sample_views(jnp.asarray(imgs),
                               jnp.asarray(grid.reshape(2, 30, 2)),
                               image_grad=False)
  _close(sample_views(_t(imgs), _t(grid)).reshape(2, 30, 4), want)


# -------------------------------------------------------------- composite


def _raw(seed):
  rng = np.random.RandomState(seed)
  raw = rng.randn(R, S, 4).astype(np.float32)
  raw[..., :3] = 1 / (1 + np.exp(-raw[..., :3]))
  raw[0, :, 3] = -1e9                    # a ray with no valid samples
  return raw


def test_composite_single_and_dual():
  ray_o, ray_d, dr = _rays()
  _, z, _ = sampling.sample_along_ray(_t(ray_o), _t(ray_d), _t(dr), S, True,
                                      True)
  raw_dy, raw_st = _raw(12), _raw(13)
  m_dy = np.random.RandomState(14).rand(R, S) > 0.3
  m_st = np.random.RandomState(15).rand(R, S) > 0.3
  got = comp.composite_single(_t(raw_dy), z, _t(m_dy))
  want = jcomp.composite_single(jnp.asarray(raw_dy), jnp.asarray(z.numpy()),
                                jnp.asarray(m_dy))
  for key in want:
    _close(got[key].float(), want[key], rtol=1e-6)
  got = comp.composite_dual(_t(raw_dy), _t(raw_st), z, _t(m_dy), _t(m_st))
  want = jcomp.composite_dual(jnp.asarray(raw_dy), jnp.asarray(raw_st),
                              jnp.asarray(z.numpy()), jnp.asarray(m_dy),
                              jnp.asarray(m_st))
  assert set(got) == set(want)
  for key in want:
    _close(got[key].float(), want[key], rtol=1e-6)


def test_render_optical_flow():
  cams = _cameras(V)
  _, xyz = _points()
  wts = _coarse_weights()
  wts[1] = 0.0                           # 0/0 guard of the divide
  uv = np.random.RandomState(16).rand(R, 2).astype(np.float32) * 40
  got = comp.render_optical_flow(_t(wts), xyz, _t(cams[1:]), _t(uv))
  want = jcomp.render_optical_flow(jnp.asarray(wts),
                                   jnp.asarray(xyz.numpy()),
                                   jnp.asarray(cams[1:]), jnp.asarray(uv))
  _close(got, want, atol=2e-3, rtol=1e-5)   # pixels
