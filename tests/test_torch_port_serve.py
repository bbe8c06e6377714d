"""The port's serving path (``dynibar_tpu_torch.serve``) on the CPU, held
against the JAX package's.

One 12-frame 32×48 scene (N_samples 10, num_source_views 2, num_vv 1,
chunk 256, f32; at 8 samples or fewer every rgb is masked to zero, since
a ray's mask needs more than 8 valid samples) and the JAX ``MonoModel``'s weights from PRNGKey(0),
bridged with ``utils/convert.load_jax_params``:

  * ``named_path`` (stabilization, wander) within 1e-6 of the JAX one;
  * ``RenderSession.render`` at stride 1 and 4 with ``layers``: rgb,
    depth, rgb_dy and rgb_st within 2e-5 (the render bar of
    test_torch_port_mono.py) of the JAX session over the same request
    sequence (both draw the templates' virtual views from one
    ``RandomState(0)``); the feature-map cache's hits and misses;
  * ``render_path("depth")`` shares one range over the path, as the JAX
    session's does;
  * the registry's LRU eviction and its unknown-scene error;
  * HTTP: every endpoint and status code (200, 400, 404, 500),
    ``/stream``'s parts decoded by ``data/png.py``, ``/video``'s mp4 (cv2
    is installed here) and its error naming cv2 when cv2 is blocked.
"""

import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.models.dynibar import MonoModel as JMonoModel
from dynibar_tpu.serve import video as jvideo
from dynibar_tpu.serve.session import RenderSession as JRenderSession
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data import png
from dynibar_tpu_torch.data.synthetic_scene import write_synthetic_scene
from dynibar_tpu_torch.models.dynibar import MonoModel
from dynibar_tpu_torch.serve import RenderSession, video
from dynibar_tpu_torch.serve.registry import SessionRegistry
from dynibar_tpu_torch.serve.server import make_server
from dynibar_tpu_torch.utils import convert
from torch_port_threads import one_torch_thread  # noqa: F401

FRAMES = 12
KW = dict(train_scenes=["tiny"], training_height=32, num_source_views=2,
          max_range=8, num_vv=1, N_samples=10, num_basis=4, chunk_size=256,
          mesh_shape="1")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  """(scene root, JAX params, the port's state_dict)."""
  root = str(tmp_path_factory.mktemp("serve"))
  write_synthetic_scene(root, "tiny", num_frames=FRAMES, height=32, width=48)
  jcfg = JConfig(folder_path=root, **KW).render_settings("mono")
  jmodel = JMonoModel(cfg=jcfg, num_frames=FRAMES)
  params = jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
  model = MonoModel(DynibarConfig(folder_path=root, **KW).render_settings(
      "mono"), FRAMES, device="cpu")
  convert.load_jax_params(model, params)
  return root, params, model.state_dict()


def _sessions(scene, featmap_cache=2):
  root, params, sd = scene
  jsession = JRenderSession(JConfig(folder_path=root, **KW), params=params,
                            featmap_cache=featmap_cache)
  session = RenderSession(DynibarConfig(folder_path=root, **KW),
                          state_dict=sd, featmap_cache=featmap_cache,
                          device="cpu")
  return jsession, session


@pytest.fixture(scope="module")
def session(scene):
  return _sessions(scene)[1]


@pytest.mark.parametrize("kind,kw", [("stabilization", {}),
                                     ("wander", dict(render_idx=5,
                                                     num_frames=7))])
def test_named_path(session, kind, kw):
  from dynibar_tpu.data.monocular import MonocularSceneData as JData
  jdata = JData(JConfig(folder_path=session.config.folder_path, **KW),
                "tiny")
  want = jvideo.named_path(kind, jdata, **kw)
  got = video.named_path(kind, session.data, **kw)
  assert got["frame_idxs"] == want["frame_idxs"]
  assert len(got["c2ws"]) == len(want["c2ws"]) > 0
  for g, w in zip(got["c2ws"], want["c2ws"]):
    np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
  with pytest.raises(ValueError, match="unknown path kind"):
    video.named_path("spiral", session.data)


def _novel(c2w, k):
  """A view off the writer's poses: the frame's camera turned by a few
  hundredths of a radian and moved a little (request k)."""
  a, b = 0.02 * (k + 1), -0.015 * (k + 1)
  rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]]) @ np.array(
                      [[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
  out = np.array(c2w, np.float64)
  out[:3, :3] = rot @ out[:3, :3]
  out[:3, 3] += [0.03, -0.02, 0.01 * k]
  return out.astype(np.float32)


@pytest.fixture(scope="module")
def renders(scene):
  """The same request sequence through both sessions: frame 5 at stride 1,
  frame 6 at stride 4 with its own intrinsics, frame 5 again (a cache
  hit), frame 7 with a 3x4 pose (evicts frame 6 from the two-frame cache),
  frame 6 again (a re-encode: new virtual views from the shared
  generator).  Every pose is off
  the writer's: its cameras share one rotation and differ along one
  axis, and at a frame's own pose a 1e-5 nudge of the pose moves either
  package's rgb by up to 0.84, an f32 tie that any two implementations
  break apart (ROADMAP.md queue 3)."""
  jsession, session = _sessions(scene)
  c2w = session.data.c2w
  k = np.array(session.data.intrinsics[6], np.float32)
  k[0, 0] *= 1.1
  reqs = [dict(c2w=_novel(c2w[5], 0), frame_idx=5),
          dict(c2w=_novel(c2w[6], 1), frame_idx=6, stride=4, intrinsics=k),
          dict(c2w=_novel(c2w[5], 2), frame_idx=5, stride=4),
          dict(c2w=_novel(c2w[7], 3)[:3], frame_idx=7, stride=4),
          dict(c2w=_novel(c2w[6], 4), frame_idx=6, stride=4)]
  out = []
  for r in reqs:
    r = dict(r, layers=True)
    out.append((session.render(**r), jsession.render(**r)))
  return session, jsession, out


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("key", ["rgb", "depth", "rgb_dy", "rgb_st"])
def test_session_render_matches_jax(renders, i, key):
  _, _, out = renders
  got, want = out[i]
  assert got[key].shape == want[key].shape
  assert got[key].dtype == np.float32
  np.testing.assert_allclose(got[key], want[key], atol=2e-5, rtol=2e-5)


def test_session_counters(renders):
  session, jsession, out = renders
  assert out[0][0]["rgb"].shape == (32, 48, 3)
  assert out[1][0]["rgb"].shape == (8, 12, 3)
  assert out[1][0]["depth"].shape == (8, 12)
  for s in (session, jsession):
    assert s.stats["renders"] == 5
    assert s.stats["featmap_cache_hits"] == 1
    assert s.stats["featmap_cache_misses"] == 4
  assert list(session._frames) == list(jsession._frames) == [7, 6]
  for got, _ in out:
    assert got["rgb"].any() and np.isfinite(got["depth"]).all()


def test_render_path_depth_shares_one_range(scene):
  jsession, session = _sessions(scene)
  c2ws = [_novel(session.data.c2w[4], 0), _novel(session.data.c2w[6], 1)]
  got = session.render_path(c2ws, [4, 6], stride=4, layer="depth")
  want = jsession.render_path(c2ws, [4, 6], stride=4, layer="depth")
  flat = np.concatenate([f.ravel() for f in got])
  assert flat.min() == 0.0 and flat.max() == pytest.approx(1.0)
  # the range is the path's, not each frame's
  assert min(float(f.max()) for f in got) < 1.0 or min(
      float(f.min()) for f in got) > 0.0
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
  with pytest.raises(ValueError, match="poses vs"):
    session.render_path(c2ws, [4])
  with pytest.raises(ValueError, match="unknown layer"):
    session.render_path(c2ws[:1], [4], stride=8, layer="normals")


def test_registry_lru_and_unknown_scene(scene):
  root, _, sd = scene
  for name in ("alpha", "beta"):
    if not os.path.exists(os.path.join(root, name)):
      os.symlink(os.path.join(root, "tiny"), os.path.join(root, name))
  config = DynibarConfig(folder_path=root, **dict(
      KW, train_scenes=["alpha", "beta"]))
  reg = SessionRegistry(config, state_dict=sd, featmap_cache=1,
                        max_sessions=1, device="cpu")
  assert reg.scenes() == {"available": ["alpha", "beta"], "loaded": [],
                          "default": "alpha", "max_sessions": 1}
  s_a = reg.get()
  assert s_a.config.train_scenes == ["alpha"] and reg.get("alpha") is s_a
  s_b = reg.get("beta")
  assert s_b is not s_a and reg.scenes()["loaded"] == ["beta"]
  assert s_b.meta()["scene"] == "beta"
  with pytest.raises(KeyError, match="unknown scene 'gamma'"):
    reg.get("gamma")
  with pytest.raises(ValueError, match="train_scenes"):
    SessionRegistry(DynibarConfig(folder_path=root), device="cpu")


@pytest.fixture(scope="module")
def server(session):
  httpd = make_server(session, "127.0.0.1", 0)
  t = threading.Thread(target=httpd.serve_forever, daemon=True)
  t.start()
  yield f"http://127.0.0.1:{httpd.server_port}", session
  httpd.shutdown()
  httpd.server_close()


def _get(url):
  try:
    with urllib.request.urlopen(url) as resp:
      return resp.status, resp.headers, resp.read()
  except urllib.error.HTTPError as e:
    return e.code, e.headers, e.read()


def _post(url, body):
  data = body if isinstance(body, bytes) else json.dumps(body).encode()
  return _get(urllib.request.Request(url, data=data))


def _pose(session, i):
  return np.asarray(session.data.c2w[i]).tolist()


def test_http_get_endpoints(server):
  base, session = server
  code, _, body = _get(f"{base}/healthz")
  assert code == 200
  assert json.loads(body) == {"status": "ok", "checkpoint_step": 0}
  code, _, body = _get(f"{base}/meta")
  meta = json.loads(body)
  assert code == 200 and meta["num_frames"] == FRAMES
  assert meta["frame_window"] == [3, 8] and meta["scene"] == "tiny"
  assert (meta["height"], meta["width"]) == (32, 48)
  code, _, body = _get(f"{base}/scenes")
  assert code == 200 and json.loads(body)["loaded"] == ["tiny"]
  code, _, body = _get(f"{base}/stats")
  assert code == 200 and set(json.loads(body)) == {"counters", "timings_s"}
  assert _get(f"{base}/meta?scene=nope")[0] == 400
  assert _get(f"{base}/nope")[0] == 404


def test_http_render(server, monkeypatch):
  base, session = server
  req = {"c2w": _pose(session, 6), "frame_idx": 6, "stride": 4,
         "format": "npy"}
  code, headers, body = _post(f"{base}/render", req)
  assert code == 200 and headers["Content-Type"] == "application/octet-stream"
  arr = np.load(io.BytesIO(body))
  want = session.render(np.asarray(req["c2w"], np.float32), 6, stride=4)
  np.testing.assert_array_equal(arr, want["rgb"])

  code, headers, body = _post(f"{base}/render", dict(req, format="png"))
  assert code == 200 and headers["Content-Type"] == "image/png"
  np.testing.assert_array_equal(
      png.decode(body), (np.clip(want["rgb"], 0, 1) * 255).astype(np.uint8))
  for layer, shape in (("depth", (8, 12)), ("rgb_dy", (8, 12, 3)),
                       ("rgb_st", (8, 12, 3))):
    code, _, body = _post(f"{base}/render", dict(req, format="png",
                                                 layer=layer))
    assert code == 200 and png.decode(body).shape == shape
  depth = png.decode(_post(f"{base}/render", dict(
      req, format="png", layer="depth"))[2])
  assert depth.min() == 0 and depth.max() == 255

  # the target camera of the request: its own size and intrinsics
  k = np.asarray(session.data.intrinsics[6], np.float32) * [[.5], [.5],
                                                            [1], [1]]
  code, _, body = _post(f"{base}/render", dict(
      req, h=16, w=24, intrinsics=k.tolist(), stride=1))
  assert code == 200 and np.load(io.BytesIO(body)).shape == (16, 24, 3)

  for bad in ({"frame_idx": 1}, dict(req, layer="normals"),
              dict(req, scene="nope"), dict(req, frame_idx="x")):
    code, _, body = _post(f"{base}/render", bad)
    assert code == 400, bad
    assert "error" in json.loads(body)
  assert _post(f"{base}/render", b"{not json")[0] == 400
  assert _post(f"{base}/nope", req)[0] == 404

  def broken(*a, **kw):
    raise RuntimeError("device lost")

  monkeypatch.setattr(session, "render", broken)
  code, _, body = _post(f"{base}/render", req)
  assert code == 500 and "device lost" in json.loads(body)["error"]


def test_http_concurrent_renders(server):
  """More client threads than cores on one session, the interpreter
  switching threads often: every response is the frame rendered alone,
  and the session counts every render (the lock serializes them)."""
  base, session = server
  req = {"c2w": _pose(session, 6), "frame_idx": 6, "stride": 8,
         "format": "npy"}
  want = session.render(np.asarray(req["c2w"], np.float32), 6, stride=8)
  before = session.stats["renders"]
  n = 2 * (os.cpu_count() or 4)
  got = [None] * n

  def client(i):
    got[i] = _post(f"{base}/render", dict(req, layer=(
        "rgb", "depth")[i % 2]))

  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  try:
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=120)
  finally:
    sys.setswitchinterval(interval)
  assert not any(t.is_alive() for t in threads)
  for i, (code, _, body) in enumerate(got):
    assert code == 200
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  want[("rgb", "depth")[i % 2]])
  assert session.stats["renders"] == before + n


def _multipart(body, boundary=b"--dynibar-frame"):
  parts = []
  for chunk in body.split(boundary)[1:]:
    if chunk.startswith(b"--"):
      break
    header, _, rest = chunk.partition(b"\r\n\r\n")
    fields = dict(line.split(b": ", 1) for line in header.split(b"\r\n")
                  if b": " in line)
    parts.append((fields, rest[:int(fields[b"Content-Length"])]))
  return parts


def test_http_stream(server):
  base, session = server
  spec = video.named_path("wander", session.data, render_idx=5,
                          num_frames=3)
  code, headers, body = _post(f"{base}/stream", {
      "path": "wander", "render_idx": 5, "num_frames": 3, "stride": 8})
  assert code == 200
  assert headers["Content-Type"].startswith("multipart/x-mixed-replace")
  assert headers["X-Frame-Count"] == "3"
  parts = _multipart(body)
  assert [f[b"X-Frame-Index"] for f, _ in parts] == [b"0", b"1", b"2"]
  for (fields, payload), c2w in zip(parts, spec["c2ws"]):
    assert fields[b"Content-Type"] == b"image/png"
    want = session.render(np.asarray(c2w, np.float32), 5, stride=8)["rgb"]
    np.testing.assert_array_equal(
        png.decode(payload), (np.clip(want, 0, 1) * 255).astype(np.uint8))

  code, _, body = _post(f"{base}/stream", {
      "c2ws": [_pose(session, 5)] * 2, "frame_idxs": [5, 5], "stride": 8,
      "format": "npy", "layer": "depth"})
  arrs = [np.load(io.BytesIO(p)) for _, p in _multipart(body)]
  assert code == 200 and [a.shape for a in arrs] == [(4, 6)] * 2
  for bad in ({"c2ws": []}, {"c2ws": [_pose(session, 5)],
                             "frame_idxs": [5, 6]},
              {"path": "spiral"}):
    assert _post(f"{base}/stream", bad)[0] == 400, bad


def test_http_video(server, monkeypatch):
  base, session = server
  code, headers, body = _post(f"{base}/video", {
      "path": "wander", "render_idx": 5, "num_frames": 3, "stride": 8,
      "fps": 8})
  assert code == 200 and headers["Content-Type"] == "video/mp4"
  assert len(body) > 100 and body[4:8] == b"ftyp"
  code, _, body = _post(f"{base}/video", {
      "c2ws": [_pose(session, 5)] * 2, "frame_idxs": [5, 5], "stride": 8,
      "layer": "depth"})
  assert code == 200 and body[4:8] == b"ftyp"
  assert _post(f"{base}/video", {"c2ws": [_pose(session, 5)],
                                 "frame_idxs": [5, 6]})[0] == 400
  # a machine without OpenCV: the error names it
  monkeypatch.setitem(sys.modules, "cv2", None)
  code, _, body = _post(f"{base}/video", {
      "c2ws": [_pose(session, 5)], "frame_idxs": [5], "stride": 8})
  assert code == 500 and "cv2" in json.loads(body)["error"]
  with pytest.raises(ImportError, match="cv2"):
    video.encode_mp4([np.zeros((4, 4, 3), np.float32)])


def test_registry_over_http(scene):
  root, _, sd = scene
  for name in ("alpha", "beta"):
    if not os.path.exists(os.path.join(root, name)):
      os.symlink(os.path.join(root, "tiny"), os.path.join(root, name))
  reg = SessionRegistry(DynibarConfig(folder_path=root, **dict(
      KW, train_scenes=["alpha", "beta"])), state_dict=sd, featmap_cache=1,
      max_sessions=2, device="cpu")
  httpd = make_server(reg, "127.0.0.1", 0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  base = f"http://127.0.0.1:{httpd.server_port}"
  try:
    assert json.loads(_get(f"{base}/scenes")[2])["available"] == [
        "alpha", "beta"]
    code, _, body = _get(f"{base}/meta?scene=beta")
    assert code == 200 and json.loads(body)["scene"] == "beta"
    code, _, body = _post(f"{base}/render", {
        "c2w": np.eye(4).tolist(), "frame_idx": 5, "scene": "beta",
        "stride": 8, "format": "npy"})
    assert code == 200 and np.load(io.BytesIO(body)).shape == (4, 6, 3)
    assert json.loads(_get(f"{base}/stats?scene=beta")[2])["counters"][
        "renders"] == 1
    assert _post(f"{base}/render", {"c2w": np.eye(4).tolist(),
                                    "frame_idx": 5, "scene": "nope"})[0] == 400
  finally:
    httpd.shutdown()
    httpd.server_close()


def test_server_main(scene, monkeypatch):
  """main: bf16 unless --f32, the warm-up render before serving unless
  --no_warmup, --max_sessions, and the scene check."""
  from dynibar_tpu_torch.serve import server
  root, _, sd = scene
  served = []
  monkeypatch.setattr(server, "serve_forever",
                      lambda reg, host, port: served.append((reg, host, port)))
  monkeypatch.setattr(server, "SessionRegistry", lambda config, **kw: (
      SessionRegistry(config, state_dict=sd, **kw)))
  args = ["--folder_path", root, "--train_scenes", "tiny", "--mesh_shape",
          "1", "--training_height", "32", "--num_source_views", "2",
          "--num_vv", "1", "--N_samples", "10", "--num_basis", "4",
          "--device", "cpu", "--port", "0", "--max_sessions", "2"]
  server.main(args)
  reg, host, port = served[-1]
  assert (host, port) == ("127.0.0.1", 0)
  assert reg.config.compute_dtype == "bfloat16"
  assert reg.scenes()["max_sessions"] == 2
  assert reg.get().stats["renders"] == 1          # the warm-up
  server.main(args + ["--f32", "--no_warmup"])
  reg = served[-1][0]
  assert reg.config.compute_dtype == "float32"
  assert reg.scenes()["loaded"] == []
  with pytest.raises(SystemExit, match="--train_scenes"):
    server.main(["--folder_path", root, "--device", "cpu"])


def test_entry_points_need_cuda_or_cpu(scene):
  root, _, sd = scene
  config = DynibarConfig(folder_path=root, **KW)
  with pytest.raises(RuntimeError, match="torchrun"):
    RenderSession(DynibarConfig(folder_path=root, **dict(
        KW, mesh_shape="8")), state_dict=sd, device="cpu")
  with pytest.raises(ValueError, match="--train_scenes"):
    RenderSession(DynibarConfig(folder_path=root), device="cpu")
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    RenderSession(config, state_dict=sd)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    SessionRegistry(config, state_dict=sd).get()
