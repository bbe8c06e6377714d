"""The port's flow IO (data/flow_io.py) against the JAX package's, on the
CPU:

  * ``read_optical_flow`` returns the JAX function's arrays and dtypes;
  * ``warp_flow`` on tensors equals the JAX ``warp_flow`` (cv2.remap,
    INTER_LINEAR, constant border) within 1e-5 on float32 gray and RGB
    images, under integer and fractional flows that carry samples out of
    the frame, and from an image larger than the flow; uint8 images within
    one level;
  * ``MonocularSceneData._load_flow`` (now ``read_optical_flow``) returns
    the JAX dataset's flows and masks exactly.
"""

import numpy as np
import pytest
import torch

from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.data import flow_io as jflow
from dynibar_tpu.data.monocular import MonocularSceneData as JMono
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data import flow_io, synthetic_scene
from dynibar_tpu_torch.data.monocular import MonocularSceneData
from torch_port_threads import one_torch_thread  # noqa: F401

H, W = 37, 53


def _flow(kind: str, h: int, w: int, seed: int) -> np.ndarray:
  rng = np.random.RandomState(seed)
  if kind == "integer":
    return rng.randint(-6, 7, (h, w, 2)).astype(np.float32)
  if kind == "sixty_fourths":        # exact halves of cv2's old 1/32 grid
    return (rng.randint(-400, 400, (h, w, 2)) / 64.0).astype(np.float32)
  return (rng.randn(h, w, 2) * 6).astype(np.float32)      # fractional


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("interval", [1, 3])
def test_read_optical_flow_matches(tmp_path, fwd, interval):
  rng = np.random.RandomState(interval)
  (tmp_path / f"flow_i{interval}").mkdir()
  np.savez(tmp_path / f"flow_i{interval}" /
           f"00004_{'fwd' if fwd else 'bwd'}.npz",
           flow=rng.randn(H, W, 2).astype(np.float32),
           mask=rng.rand(H, W) > 0.5)
  got = flow_io.read_optical_flow(str(tmp_path), 4, fwd, interval)
  want = jflow.read_optical_flow(str(tmp_path), 4, fwd, interval)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["integer", "fractional", "sixty_fourths"])
@pytest.mark.parametrize("shape", [(H, W), (H, W, 3)])
def test_warp_flow_matches_cv2(kind, shape):
  img = np.random.RandomState(1).rand(*shape).astype(np.float32)
  flow = _flow(kind, H, W, 2)
  want = jflow.warp_flow(img, flow)
  got = flow_io.warp_flow(torch.from_numpy(img), torch.from_numpy(flow))
  assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
  gx = flow[..., 0] + np.arange(W)
  gy = flow[..., 1] + np.arange(H)[:, None]
  outside = (gx < 0) | (gx > W - 1) | (gy < 0) | (gy > H - 1)
  assert outside.mean() > 0.05            # samples leave the frame
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_warp_flow_from_a_larger_image_and_uint8():
  img = np.random.RandomState(3).rand(H + 9, W + 14, 3).astype(np.float32)
  flow = _flow("fractional", H, W, 4)
  got = flow_io.warp_flow(torch.from_numpy(img), torch.from_numpy(flow))
  np.testing.assert_allclose(got.numpy(), jflow.warp_flow(img, flow),
                             rtol=0, atol=1e-5)
  img8 = (img * 255).astype(np.uint8)
  got8 = flow_io.warp_flow(torch.from_numpy(img8), torch.from_numpy(flow))
  want8 = jflow.warp_flow(img8, flow)
  assert got8.dtype == torch.uint8 and tuple(got8.shape) == want8.shape
  assert np.abs(got8.numpy().astype(int) - want8).max() <= 1


def test_load_flow_is_unchanged(tmp_path):
  h, w = 37, 52
  synthetic_scene.write_synthetic_scene(str(tmp_path), "s", num_frames=9,
                                        height=h, width=w)
  kw = dict(folder_path=str(tmp_path), train_scenes=["s"],
            training_height=h, num_source_views=3, num_vv=2, max_range=10)
  port = MonocularSceneData(DynibarConfig(**kw), "s")
  ref = JMono(JConfig(**kw), "s")
  for idx in (3, 5):
    for offset in (1, 2, 3, -1, -2, -3):
      got, want = port._load_flow(idx, offset), ref._load_flow(idx, offset)
      for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
