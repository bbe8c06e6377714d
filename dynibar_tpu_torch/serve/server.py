"""HTTP rendering service around :class:`serve.session.RenderSession`.

Port of ``dynibar_tpu.serve.server``.  Stdlib only (ThreadingHTTPServer);
endpoints:

  GET  /healthz   -> {"status": "ok", "checkpoint_step": N}
  GET  /meta      -> scene metadata (frames, resolution, depth range)
  GET  /scenes    -> {"available": [...], "loaded": [...], ...}
  GET  /stats     -> render/cache counters and cumulative timings
  POST /render    -> image bytes
      JSON body: {"c2w": [[...4x4 or 3x4...]],      (required)
                  "frame_idx": int,                  (required)
                  "scene": str,                      (optional, multi-scene)
                  "h": int, "w": int,                (optional)
                  "intrinsics": [[...4x4...]],       (optional)
                  "stride": int,                     (optional, preview)
                  "format": "png" | "npy",           (optional, default png)
                  "layer": "rgb" | "rgb_dy" | "rgb_st" | "depth"}
  POST /video     -> video/mp4 bytes (buffered; body below; needs cv2)
  POST /stream    -> multipart/x-mixed-replace stream of PNG (or npy)
      frames, one part per camera-path pose, written as each frame
      finishes rendering: a client sees the first frame after one
      render, not after the whole path.  Same body as /video.

POST bodies addressing a multi-scene server carry {"scene": name};
omitted -> the first configured scene.  GET endpoints take ?scene=name.

    python -m dynibar_tpu_torch.serve.server --config <cfg> \\
        --train_scenes <scene> --port 8008 [--device cpu]

Serving renders in bf16 (``compute_dtype = "bfloat16"``); ``--f32`` keeps
the config file's dtype.  On the card the kernels run without a flag.
``--no_warmup`` skips the warm-up render (which builds the kernels) before
the port opens; ``--max_sessions`` bounds the resident scenes.  One render
runs at a time per scene; HTTP threads queue on the session lock.  PNGs
are encoded by ``data/png.py``.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Union

import numpy as np

from dynibar_tpu_torch.cli.render_monocular import NO_SCENE
from dynibar_tpu_torch.cli.train import parse_args
from dynibar_tpu_torch.data import png
from dynibar_tpu_torch.serve import video as video_lib
from dynibar_tpu_torch.serve.registry import SessionRegistry
from dynibar_tpu_torch.serve.session import RenderSession


def _encode_png(img: np.ndarray) -> bytes:
  return png.encode((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))


def _encode_npy(arr: np.ndarray) -> bytes:
  buf = io.BytesIO()
  np.save(buf, arr)
  return buf.getvalue()


def _image_payload(img: np.ndarray, fmt: str):
  """(bytes, content type); a depth map becomes a normalized gray PNG."""
  if fmt == "npy":
    return _encode_npy(img), "application/octet-stream"
  if img.ndim == 2:
    lo, hi = float(img.min()), float(img.max())
    img = (img - lo) / max(hi - lo, 1e-8)
  return _encode_png(img), "image/png"


class _Handler(BaseHTTPRequestHandler):
  registry: SessionRegistry  # injected by make_server

  # ------------------------------------------------------------- plumbing
  def _send(self, code: int, body: bytes, ctype: str = "application/json"):
    self.send_response(code)
    self.send_header("Content-Type", ctype)
    self.send_header("Content-Length", str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def _send_json(self, code: int, obj) -> None:
    self._send(code, json.dumps(obj).encode())

  def _send_error(self, e: Exception) -> None:
    """400 for a malformed request, else 500 with the traceback on
    stderr; the server keeps running."""
    code = 400 if isinstance(e, (KeyError, ValueError, TypeError)) else 500
    if code == 500:
      traceback.print_exception(e)
    self._send_json(code, {"error": f"{type(e).__name__}: {e}"})

  def _body(self) -> dict:
    length = int(self.headers.get("Content-Length", "0"))
    return json.loads(self.rfile.read(length) or b"{}")

  def _session(self, req: Optional[dict] = None) -> RenderSession:
    return self.registry.get((req or {}).get("scene"))

  def log_message(self, fmt, *args):  # quiet by default
    pass

  # ------------------------------------------------------------------ GET
  def do_GET(self):
    from urllib.parse import parse_qs, urlparse
    url = urlparse(self.path)
    # GET endpoints select a scene with ?scene=<name>
    q = {k: v[0] for k, v in parse_qs(url.query).items()}
    try:
      if url.path == "/healthz":
        s = self._session(q)
        self._send_json(200, {"status": "ok",
                              "checkpoint_step": int(s.step)})
      elif url.path == "/meta":
        self._send_json(200, self._session(q).meta())
      elif url.path == "/scenes":
        self._send_json(200, self.registry.scenes())
      elif url.path == "/stats":
        s = self._session(q)
        self._send_json(200, {"counters": dict(s.stats),
                              "timings_s": dict(s.timings)})
      else:
        self._send_json(404, {"error": f"unknown path {url.path}"})
    except KeyError as e:
      self._send_json(400, {"error": str(e)})

  # ----------------------------------------------------------------- POST
  def do_POST(self):
    if self.path == "/video":
      self._do_video()
      return
    if self.path == "/stream":
      self._do_stream()
      return
    if self.path != "/render":
      self._send_json(404, {"error": f"unknown path {self.path}"})
      return
    try:
      req = self._body()
      c2w = np.asarray(req["c2w"], np.float32)
      layer = req.get("layer", "rgb")
      out = self._session(req).render(
          c2w, int(req["frame_idx"]),
          h=req.get("h"), w=req.get("w"),
          intrinsics=(np.asarray(req["intrinsics"], np.float32)
                      if req.get("intrinsics") is not None else None),
          stride=int(req.get("stride", 1)),
          layers=layer in ("rgb_dy", "rgb_st"))
      if layer not in out:
        self._send_json(400, {"error": f"unknown layer {layer!r}"})
        return
      self._send(200, *_image_payload(out[layer], req.get("format", "png")))
    except Exception as e:  # noqa: BLE001 (keep the server alive)
      self._send_error(e)

  def _do_video(self):
    """POST /video -> video/mp4 bytes.

    JSON body, either an explicit path:
        {"c2ws": [[...4x4...], ...], "frame_idxs": [int, ...]}
    or a named generator over the loaded scene:
        {"path": "stabilization" | "wander",
         "render_idx": int,            (wander center; optional)
         "num_frames": int}            (wander length; optional)
    plus common options {"fps": 24, "stride": 1,
                         "layer": "rgb"|"rgb_dy"|"rgb_st"|"depth"}.
    """
    try:
      req = self._body()
      session = self._session(req)
      c2ws, idxs = _path_spec(req, session)
      frames = session.render_path(
          c2ws, idxs, stride=int(req.get("stride", 1)),
          layer=req.get("layer", "rgb"))
      body = video_lib.encode_mp4(frames, fps=float(req.get("fps", 24.0)))
      self._send(200, body, "video/mp4")
    except Exception as e:  # noqa: BLE001 (keep the server alive)
      self._send_error(e)

  def _do_stream(self):
    """POST /stream -> multipart/x-mixed-replace frame stream.

    Same body as /video plus {"format": "png" | "npy"}.  Each camera-path
    frame is written as ONE multipart part the moment its render returns:
    a preview client displays frame k while frame k+1 renders.  Depth
    frames are normalized per frame here (the whole path's range is
    unknown before the last frame; /video normalizes over the path).
    """
    boundary = "dynibar-frame"
    try:
      req = self._body()
      session = self._session(req)
      c2ws, idxs = _path_spec(req, session)
      if len(c2ws) != len(idxs):
        raise ValueError(f"{len(c2ws)} poses vs {len(idxs)} frame_idxs")
      stride = int(req.get("stride", 1))
      layer = req.get("layer", "rgb")
      fmt = req.get("format", "png")
    except Exception as e:  # noqa: BLE001
      self._send_error(e)
      return

    self.send_response(200)
    self.send_header("Content-Type",
                     f"multipart/x-mixed-replace; boundary={boundary}")
    self.send_header("X-Frame-Count", str(len(c2ws)))
    self.end_headers()
    try:
      for i, (c2w, idx) in enumerate(zip(c2ws, idxs)):
        out = session.render(np.asarray(c2w, np.float32), int(idx),
                             stride=stride,
                             layers=layer in ("rgb_dy", "rgb_st"))
        if layer not in out:
          break  # a streamed response cannot switch to an error code
        payload, ctype = _image_payload(out[layer], fmt)
        self.wfile.write(
            f"--{boundary}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"X-Frame-Index: {i}\r\n\r\n".encode())
        self.wfile.write(payload)
        self.wfile.write(b"\r\n")
        self.wfile.flush()
      self.wfile.write(f"--{boundary}--\r\n".encode())
    except (BrokenPipeError, ConnectionResetError):
      pass  # the client went away mid-path; stop rendering


def _path_spec(req: dict, session: RenderSession):
  """Shared /video + /stream body parsing -> (c2ws, frame_idxs)."""
  if "path" in req:
    spec = video_lib.named_path(
        req["path"], session.data,
        render_idx=int(req.get("render_idx", -1)),
        num_frames=req.get("num_frames"))
    return spec["c2ws"], spec["frame_idxs"]
  c2ws = [np.asarray(p, np.float32) for p in req["c2ws"]]
  idxs = [int(i) for i in req["frame_idxs"]]
  return c2ws, idxs


def make_server(target: Union[RenderSession, SessionRegistry],
                host: str = "127.0.0.1", port: int = 0
                ) -> ThreadingHTTPServer:
  """Build (not start) the HTTP server; port=0 picks a free port.

  `target` is a SessionRegistry (multi-scene) or a bare RenderSession
  (wrapped into a single-entry registry)."""
  registry = (SessionRegistry.from_session(target)
              if isinstance(target, RenderSession) else target)
  handler = type("BoundHandler", (_Handler,), {"registry": registry})
  return ThreadingHTTPServer((host, port), handler)


def serve_forever(target: Union[RenderSession, SessionRegistry],
                  host: str, port: int,
                  ready: Optional[threading.Event] = None) -> None:
  httpd = make_server(target, host, port)
  if ready is not None:
    ready.set()
  print(f"dynibar_tpu_torch renderer serving on "
        f"http://{host}:{httpd.server_port}", flush=True)
  httpd.serve_forever()


def main(argv: Optional[List[str]] = None) -> None:
  ap = argparse.ArgumentParser(add_help=False)
  ap.add_argument("--host", default="127.0.0.1")
  ap.add_argument("--port", type=int, default=8008)
  ap.add_argument("--no_warmup", action="store_true")
  ap.add_argument("--max_sessions", type=int, default=4,
                  help="resident scenes (LRU-evicted beyond this)")
  ap.add_argument("--f32", action="store_true",
                  help="keep the config dtype instead of the bf16 serving "
                       "default")
  args, rest = ap.parse_known_args(argv)
  config, device = parse_args(rest)
  if not config.train_scenes:
    raise SystemExit(NO_SCENE)
  if not args.f32:
    # the serving default: bf16 wherever the precision policy allows;
    # checkpoints are dtype-independent (the weights stay f32)
    config.compute_dtype = "bfloat16"
  registry = SessionRegistry(config, max_sessions=args.max_sessions,
                             device=device)
  if not args.no_warmup:
    dt = registry.get().warmup()
    print(f"warmup render (kernel build) took {dt:.1f}s", flush=True)
  serve_forever(registry, args.host, args.port)


if __name__ == "__main__":
  main(sys.argv[1:])
