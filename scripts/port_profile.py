"""Where the port's FF eval chunk, or a train step, spends device time.

    python3 scripts/port_profile.py [--chunk 1024] [--iters 3]
    python3 scripts/port_profile.py --train [--chunk 3072] [--iters 2]
    python3 scripts/port_profile.py --mono [--route pallas_split3|pallas]
        [--chunk 3072] [--iters 2]
    python3 scripts/port_profile.py --forward [--iters 3]
    python3 scripts/port_profile.py --backward [--iters 3]
    python3 scripts/port_profile.py --frame [--iters 3]
    python3 scripts/port_profile.py --serve [--iters 3]
    python3 scripts/port_profile.py --sample [--iters 3]
    python3 scripts/port_profile.py --phases [fwd|bwd] [--train | --mono |
        --forward] [...]

Renders one chunk (64+64 samples, 7+11 views, 288x512 sources, bf16,
random weights from a seed) through the kernel path on the CUDA card under
torch.profiler; with --train runs FF fine-stage train steps (7 dynamic, 6
anchor, 11 static views, N_rand = --chunk); with --mono runs mono train
steps at bench.py's width (64 samples, 9 dynamic, 10 anchor, 14 static
views, 48 frames, schedule_weights(epoch=2)) on the backward route
--route: "pallas_split" (K5a + K5b, K4a + K4b), "pallas_split3" (static
K5a + K5c + K5d) or "pallas" (dynamic K3p forward, K4s backward); with
--forward launches the forward aggregators K2 and K3 alone (no grad,
random inputs and weights from a seed) at the shapes of FORWARD_SHAPES:
the FF eval fine stage, the FF step's fine stage and the mono step; with
--backward runs one fwd+bwd of an aggregator alone (random inputs, weights
and cotangent from a seed) at each of BACKWARD_SHAPES, the training
kernels' shapes: the dynamic one on routes "pallas_split" (K3r, K4a, K4b)
and "pallas" (K3p, K4s), the static one on "pallas_split3" (K2r, K5a,
K5c, K5d); with --frame renders 288x512 FF frames (render_image_ff at chunk 4096, the
featmap encode included) and prints their host-clock seconds (one
warm-up, then --iters frames; no profiler); with --serve renders warm
288x512 frames through serve/session.RenderSession (a 48-frame synthetic
scene written to a temporary directory, configs/test_kid-running.txt's
render settings, seeded weights, frame 24's own pose; the first, cold
request timed on the host clock, then the warm ones under the profiler);
with --sample runs the
sampler K1 alone at the FF eval chunk's four calls (1024 rays, S 64 and
128, 7 and 11 views, 288x512 RGB and 72x128x32 feature maps, bf16, grids
along epipolar segments from a seed): the fused launch into rgb_feat
(where the tree has it) and the gather it replaced (K1 on each map, the
concatenation and the aggregators' contiguous copy), one profile each.
Prints the device time per kernel name (summed over the profiled
iterations, divided by them), the wall time per iteration and the
device's busy share of it, and the peak device memory of the profiled
iterations (--forward, --backward: per shape, each kernel's device ms per
launch).  With --phases the aggregator libraries load from their
phase-clock builds (ops/build.py use_phase_clocks, csrc/phase_clock.cuh):
"bwd" the backwards (static_agg_bwd: K5a, K5b; static_agg_bwd3: K5c,
K5d; dynamic_agg_bwd: K4a, K4b; dynamic_agg_bwd1: K4s as its trunk recompute,
ray phase, trunk-bwd phase and the barriers between them), "fwd" the
forwards (static_agg: K2/K2r, dynamic_agg: K3/K3r/K3p, trunk and ray
launch each), no value both.  After the profile, one more --iters
iterations run with the clocks zeroed before them, and each kernel's
phases are printed as shares of its clock cycles and as ms of its
profiled device time; also the registers, stack and spills nvcc reported
for the kernels of the clocked libraries (production and phase-clock
builds), and any ptxas warning C7520 (wgmma serialized).  Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynibar_tpu_torch.config import (RenderSettings,  # noqa: E402
                                      TrainSettings, mono_render_settings)
from dynibar_tpu_torch.data.ray_batch import (  # noqa: E402
    synthetic_ff_batch, synthetic_mono_batch)
from dynibar_tpu_torch.models.aggregators import (  # noqa: E402
    DynamicAggregator, StaticAggregator)
from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel  # noqa: E402
from dynibar_tpu_torch.ops import agg  # noqa: E402
from dynibar_tpu_torch.ops import build  # noqa: E402
from dynibar_tpu_torch.render.render_rays import render_rays_mv  # noqa: E402
from dynibar_tpu_torch.train import losses, trainer  # noqa: E402
from dynibar_tpu_torch.utils import kernel_check  # noqa: E402
from dynibar_tpu_torch.utils.device import (resolve_device,  # noqa: E402
                                            to_device)


# phase names of csrc/phase_clock.cuh, the library, a pattern of the
# profiler's kernel name, the first counter and the counter of thread 0's
# waits on weight slabs
RAY_PHASES = ("A recompute", "B head fwd", "B head transposed", "B head dW",
              "B elementwise", "C attention", "C dW",
              "D geometry + pooling-2", "D dW")
TRUNK_PHASES = ("masks + pooling-1 fwd", "view fwd recompute",
                "view transposed", "view dW", "view elementwise",
                "pooling-1 bwd", "input MLP", "input MLP dW",
                "anti-alias chain")
FWD_RAY_PHASES = ("q/k/v", "attention", "fc + layer norm", "sigma head",
                  "head inputs", "head products", "blend softmax")
FWD_TRUNK_PHASES = ("input features", "input MLP products", "pooling-1",
                    "view products", "view elementwise",
                    "re-pooling + geometry_fc")
INMLP_PHASES = ("input staging + encodings", "forward recompute",
                "transposed products", "dW (products + flush)",
                "bias gradients", "output assembly")
SINGLE_PHASES = ("trunk recompute", "ray phase", "trunk-bwd phase",
                 "hand-off (barriers between phases)")
PHASES = {
    "K5a": (RAY_PHASES, "static_agg_bwd", r"agg::static_ray_bwd_kernel", 0,
            15),
    "K5b": (TRUNK_PHASES, "static_agg_bwd", r"agg::static_trunk_bwd_kernel",
            16, 31),
    "K4a": (RAY_PHASES, "dynamic_agg_bwd",
            r"agg::dynamic_ray_bwd_kernel", 0, 15),
    "K4b": (TRUNK_PHASES, "dynamic_agg_bwd", r"agg::trunk_bwd_kernel<false>",
            16, 31),
    "K5c": (TRUNK_PHASES, "static_agg_bwd3", r"agg::trunk_bwd_kernel<true>",
            16, None),
    "K5d": (INMLP_PHASES, "static_agg_bwd3", r"inmlp_bwd_kernel", 0, None),
    "K4s": (SINGLE_PHASES, "dynamic_agg_bwd1", r"dynamic_bwd_single_kernel",
            9, 15),
    "K2 trunk": (FWD_TRUNK_PHASES, "static_agg", r"agg::trunk_kernel<true>",
                 16, None),
    "K2 ray": (FWD_RAY_PHASES, "static_agg", r"agg::ray_kernel<true>", 0,
               None),
    "K3 trunk": (FWD_TRUNK_PHASES, "dynamic_agg",
                 r"agg::trunk_kernel<false>", 16, None),
    "K3 ray": (FWD_RAY_PHASES, "dynamic_agg", r"agg::ray_kernel<false>", 0,
               None)}
PHASE_LIBS = {"bwd": ("static_agg_bwd", "static_agg_bwd3", "dynamic_agg_bwd",
                      "dynamic_agg_bwd1"),
              "fwd": ("static_agg", "dynamic_agg")}
PHASE_LIBS["all"] = PHASE_LIBS["bwd"] + PHASE_LIBS["fwd"]

# --forward: (label, [(static, rays, samples, views), ...]); K2 and K2r,
# K3, K3r and K3p are the same two launches
FORWARD_SHAPES = (
    ("FF eval fine", ((True, 1024, 128, 11), (False, 1024, 128, 7))),
    ("FF step", ((True, 3072, 128, 11), (False, 3072, 128, 7),
                 (False, 3072, 128, 6))),
    ("mono step", ((True, 3072, 64, 14), (False, 3072, 64, 9),
                   (False, 3072, 64, 10))))

# --backward: (label, [(static, rays, samples, views), ...]), each shape on
# BACKWARD_ROUTES
BACKWARD_SHAPES = (
    ("FF step", ((False, 3072, 128, 7), (False, 3072, 128, 6))),
    ("mono step", ((False, 3072, 64, 9), (False, 3072, 64, 10),
                   (True, 3072, 64, 14))))
BACKWARD_ROUTES = {True: ("pallas_split3",), False: ("pallas_split", "pallas")}

# --route -> (fused_st_bwd_impl, fused_bwd_impl)
ROUTES = {"pallas_split": ("pallas_split", "pallas_split"),
          "pallas_split3": ("pallas_split3", "pallas_split"),
          "pallas": ("pallas_split", "pallas")}


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--chunk", type=int, default=1024)
  ap.add_argument("--iters", type=int, default=3)
  ap.add_argument("--train", action="store_true")
  ap.add_argument("--mono", action="store_true")
  ap.add_argument("--route", default="pallas_split", choices=sorted(ROUTES),
                  help="the mono step's backward route")
  ap.add_argument("--forward", action="store_true",
                  help="the forward aggregators alone at FORWARD_SHAPES")
  ap.add_argument("--backward", action="store_true",
                  help="an aggregator's fwd+bwd alone at BACKWARD_SHAPES")
  ap.add_argument("--frame", action="store_true",
                  help="host-clock seconds per 288x512 FF frame")
  ap.add_argument("--sample", action="store_true",
                  help="the sampler K1 alone at the FF eval chunk's calls")
  ap.add_argument("--serve", action="store_true",
                  help="warm 288x512 frames served by RenderSession")
  ap.add_argument("--phases", nargs="?", const="all", default=None,
                  choices=sorted(PHASE_LIBS),
                  help="per-phase clocks of the backwards K5a/K5b, K5c/K5d, "
                  "K4a/K4b, K4s (bwd), the forwards K2, K3 (fwd) or both (no "
                  "value)")
  args = ap.parse_args()
  args.phase_libs = PHASE_LIBS[args.phases] if args.phases else ()
  build.use_phase_clocks(args.phase_libs)
  dev = resolve_device(None)
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip()
  libs = (("static_agg", "dynamic_agg") if args.forward
          else ("sample",) if args.sample
          else ("sample", "static_agg", "dynamic_agg") if args.serve
          else build.KERNEL_SOURCES if args.train or args.mono
          or args.backward
          else ("sample", "static_agg", "dynamic_agg"))
  build.build_jobs([(n, False) for n in libs]
                   + [(n, True) for n in args.phase_libs])
  if args.forward:
    return _forward(args, card, dev)
  if args.backward:
    return _backward(args, card, dev)
  if args.frame:
    return _frame(args, card, dev)
  if args.sample:
    return _sample(args, card, dev)
  if args.serve:
    return _serve(args, card, dev)
  if args.mono:
    cfg = mono_render_settings(num_source_views=7, num_vv=3, n_samples=64,
                               num_basis=6, compute_dtype="bfloat16",
                               fused_st_bwd_impl=ROUTES[args.route][0],
                               fused_bwd_impl=ROUTES[args.route][1])
    model = MonoModel(cfg, num_frames=48, seed=0).train_all()
    rb = to_device(synthetic_mono_batch(cfg, n_rays=args.chunk, h=288,
                                        w=512, num_frames=48), dev)
    t_cfg = TrainSettings()
    opt = trainer.make_mono_optimizer(model, t_cfg)
    weights = losses.schedule_weights(t_cfg, 2)

    def one():
      trainer.mono_train_step(model, opt, rb, weights, cfg, t_cfg,
                              generator=torch.Generator(dev).manual_seed(0))
    return _profile(one, args, card,
                    f"mono train step N_rand {args.chunk} ({args.route})")
  cfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                       num_views_anchor=6 if args.train else 0,
                       num_views_static=11, num_basis=6, inv_uniform=True,
                       compute_dtype="bfloat16")
  model = FFModel(cfg, num_frames=48, seed=0)
  rb = to_device(synthetic_ff_batch(cfg, n_rays=args.chunk, h=288, w=512,
                                    num_frames=48,
                                    scanline=not args.train), dev)
  if args.train:
    t_cfg = TrainSettings()
    model.train_fine()
    opt = trainer.make_ff_optimizer(model, t_cfg)
    weights = losses.schedule_weights(t_cfg, 0)

    def one():
      trainer.ff_train_step(model, opt, rb, weights, cfg, t_cfg,
                            generator=torch.Generator(dev).manual_seed(0))
  else:
    with torch.no_grad():
      coarse, fine = model.encode_featmaps(rb["src_rgbs"],
                                           rb["static_src_rgbs"])

    def one():
      render_rays_mv(model, rb, coarse, fine, cfg)
  return _profile(one, args, card,
                  f"train step N_rand {args.chunk}" if args.train
                  else f"chunk {args.chunk}")


def _frame(args, card: str, dev) -> int:
  """--iters full frames after one warm-up, timed on the host clock."""
  from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                     render_image_ff)
  h, w = 288, 512
  cfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                       num_views_anchor=0, num_views_static=11, num_basis=6,
                       inv_uniform=True, compute_dtype="bfloat16")
  model = FFModel(cfg, num_frames=48, seed=0)
  rb = to_device(synthetic_ff_batch(cfg, n_rays=1024, h=h, w=w,
                                    num_frames=48, scanline=True), dev)
  frame_rb = full_image_ray_batch(rb, rb["camera"])

  def one():
    with torch.no_grad():
      c, f = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
    render_image_ff(model, frame_rb, c, f, cfg, chunk_size=4096, height=h,
                    width=w)

  one()
  torch.cuda.synchronize()
  secs = []
  for _ in range(args.iters):
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
  print(f"card: {card}")
  print(f"frame {h}x{w}: {sum(secs) / len(secs):.4f} s/frame, mean of "
        f"{len(secs)} (min {min(secs):.4f}, max {max(secs):.4f})")
  print(json.dumps({"what": "frame", "s_per_frame": secs, "card": card}))
  return 0


def _serve(args, card: str, dev) -> int:
  """--iters warm served frames under the profiler, after a cold one."""
  import tempfile
  from dynibar_tpu_torch.cli.train import parse_args
  from dynibar_tpu_torch.data.synthetic_scene import write_synthetic_scene
  from dynibar_tpu_torch.serve import RenderSession
  kid = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
      __file__))), "configs", "test_kid-running.txt")
  with tempfile.TemporaryDirectory() as root:
    write_synthetic_scene(root, "scene", num_frames=48, height=288,
                          width=512)
    config = parse_args(["--config", kid, "--folder_path", root,
                         "--train_scenes", "scene"])[0]
    model = MonoModel(config.render_settings("mono"), num_frames=48, seed=0)
    session = RenderSession(config, state_dict=model.state_dict(),
                            device=dev)
    del model
    frame = 24
    pose = session.data.c2w[frame]
    t0 = time.perf_counter()
    session.render(pose, frame)
    print(f"cold request: {time.perf_counter() - t0:.4f} s (template, "
          f"feature maps, kernel loads, the frame)")

    def one():
      session.render(pose, frame)
    return _profile(one, args, card,
                    f"served frame 288x512 chunk {config.chunk_size}")


def _sample(args, card: str, dev) -> int:
  """K1 at each of the FF eval chunk's four calls: the fused launch (where
  ops/sample.py has it) and the two single-map launches with the
  concatenation and the contiguous copy in [R,S,V,3+C], one profile each.
  Each ray's samples walk a segment of an epipolar line in every view, the
  rays' segments start in a 64x64-pixel patch."""
  from dynibar_tpu_torch.ops import sample
  pair = getattr(sample, "sample_views_pair", None)
  gen = torch.Generator(device=dev).manual_seed(0)
  r = 1024
  for s, v in ((64, 7), (64, 11), (128, 7), (128, 11)):
    rgbs = torch.rand(v, 288, 512, 3, generator=gen, device=dev).to(
        torch.bfloat16)
    feats = torch.randn(v, 72, 128, 32, generator=gen, device=dev).to(
        torch.bfloat16)
    start = (torch.rand(v, r, 1, 2, generator=gen, device=dev) * 0.25 - 0.125)
    step = torch.rand(v, 1, 1, 2, generator=gen, device=dev) * 1.6 - 0.8
    t = torch.linspace(0.0, 1.0, s, device=dev).view(1, 1, s, 1)
    grid = (start + t * step).contiguous()

    def chain(rgbs=rgbs, feats=feats, grid=grid):
      rgb_feat = torch.cat([sample.sample_views(rgbs, grid),
                            sample.sample_views(feats, grid)], dim=-1)
      return rgb_feat.permute(1, 2, 0, 3).contiguous()
    _profile(chain, args, card, f"K1 gather, cat and copy R {r} S {s} V {v}")
    if pair is not None:
      _profile(lambda rgbs=rgbs, feats=feats, grid=grid: pair(rgbs, feats,
                                                              grid),
               args, card, f"K1 fused R {r} S {s} V {v}")
  return 0


def _forward(args, card: str, dev) -> int:
  """K2 and K3 alone at each of FORWARD_SHAPES, one profile per shape."""
  for label, shapes in FORWARD_SHAPES:
    for static, r, s, v in shapes:
      torch.manual_seed(0)
      net = (StaticAggregator(32, s) if static
             else DynamicAggregator(32, s, shift=0.0)).to(dev).eval()
      d = kernel_check.random_inputs(dev, r, s, v, seed=r + s + v, c=35)
      names = (kernel_check.STATIC_INPUTS if static
               else kernel_check.DYNAMIC_INPUTS)
      ins = [d[k] for k in names]
      fused = (agg.fused_static_aggregator if static
               else agg.fused_dynamic_aggregator)

      def one(fused=fused, net=net, ins=ins):
        with torch.no_grad():
          fused(net, *ins)
      _profile(one, args, card, f"{label}: {'K2' if static else 'K3'} "
               f"R {r} S {s} V {v}")
  return 0


def _backward(args, card: str, dev) -> int:
  """One aggregator's fwd+bwd (kernel_check.aggregator_grads, the kernels
  through the autograd Functions) at each of BACKWARD_SHAPES on each of
  its BACKWARD_ROUTES, one profile each."""
  for label, shapes in BACKWARD_SHAPES:
    for static, r, s, v in shapes:
      for route in BACKWARD_ROUTES[static]:
        torch.manual_seed(0)
        net = (StaticAggregator(32, s) if static
               else DynamicAggregator(32, s, shift=0.0)).to(dev)
        d = kernel_check.random_inputs(dev, r, s, v, seed=r + s + v, c=35)
        names = (kernel_check.STATIC_INPUTS if static
                 else kernel_check.DYNAMIC_INPUTS)
        ins = [d[k] for k in names]
        cot = torch.randn(r, s, 4, generator=torch.Generator().manual_seed(
            r + s)).to(dev)

        def one(net=net, ins=ins, cot=cot, static=static, route=route):
          kernel_check.aggregator_grads(net, static, ins, cot, "kernel",
                                        bwd=route)
        kind = "static" if static else "dynamic"
        _profile(one, args, card,
                 f"{label}: {kind} R {r} S {s} V {v} route {route}")
  return 0


def _profile(one, args, card: str, what: str) -> int:
  """Two warm-up iterations, then --iters under torch.profiler; prints the
  table and a JSON line."""
  for _ in range(2):
    one()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    t0 = time.perf_counter()
    for _ in range(args.iters):
      one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.iters
  rows = []
  for ev in prof.key_averages():
    if not str(ev.device_type).endswith("CUDA"):
      continue                    # host ops: their kernels are listed too
    dev_us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
    if dev_us > 0:
      rows.append((dev_us / args.iters / 1e3, ev.count // args.iters,
                   ev.key))
  rows.sort(reverse=True)
  busy = sum(r[0] for r in rows)
  peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
  if args.phase_libs:
    _phases(one, args, card, rows)
  print(f"card: {card}")
  print(f"{what}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), peak memory "
        f"{peak_gib:.3f} GiB")
  for ms, n, name in rows[:25]:
    print(f"{ms:9.3f} ms  x{n:<4d} {name[:90]}")
  print(json.dumps({"what": what, "wall_ms": wall * 1e3,
                    "device_busy_ms": busy, "peak_gib": peak_gib,
                    "card": card,
                    "top": [[name[:60], ms] for ms, _, name in rows[:10]]}))
  return 0


def _phases(one, args, card: str, rows) -> None:
  """--iters more steps with the phase clocks zeroed before them; print
  each kernel's phases and nvcc's resource lines."""
  fns, bufs = {}, {}
  libs = args.phase_libs
  for lib in libs:
    fns[lib] = build.load(lib).dyn_phase_clocks
    fns[lib].argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fns[lib].restype = ctypes.c_int
    bufs[lib] = (ctypes.c_ulonglong * 32)()
  torch.cuda.synchronize()
  for lib in libs:
    build.check(fns[lib](bufs[lib], 1), "phase clocks")
  for _ in range(args.iters):
    one()
  torch.cuda.synchronize()
  for lib in libs:
    build.check(fns[lib](bufs[lib], 1), "phase clocks")
  out = {}
  for key, (names, lib, pattern, first, wait) in PHASES.items():
    if lib not in libs:
      continue
    buf = bufs[lib]
    cyc = list(buf)[first:first + len(names)]
    total = max(sum(cyc), 1)
    ms = sum(r[0] for r in rows if re.search(pattern, r[2]))
    if ms == 0 and sum(cyc) == 0:
      continue                    # not on this step's route
    print(f"{key} phases ({pattern}: {ms:.3f} ms device time per step in "
          f"the profile; {total} clock64 cycles over its blocks) [{card}]")
    for name, c in zip(names, cyc):
      print(f"  {name:28s} {100 * c / total:6.2f}%  {ms * c / total:8.3f} ms")
    out[key] = dict(ms=ms, cycles=total,
                    share={n: c / total for n, c in zip(names, cyc)})
    if wait is None:              # the forwards have no weight ring
      continue
    for name, c in (("waiting on weight slabs", buf[wait]),
                    ("the slabs' products", buf[wait - 1]),
                    ("the products' epilogues", buf[wait - 2])):
      print(f"  ({name}, thread 0, within the above: {100 * c / total:.2f}%,"
            f" {ms * c / total:.3f} ms)")
    out[key].update(slab_wait=buf[wait] / total,
                    slab_mma=buf[wait - 1] / total,
                    epilogue=buf[wait - 2] / total)
  print(json.dumps({"phases": out, "card": card}))
  for lib in libs:
    for phases in (False, True):
      log = build.library_path(lib, phases).with_suffix(".log")
      if log.exists():
        print(f"nvcc resources ({log.name}):")
        for entry, props, regs in _ptxas(log.read_text()):
          print(f"  {entry}: {props}; {regs}")
        for line in log.read_text().splitlines():
          if "C7520" in line:
            print(f"  ptxas: {line.strip()[:200]}")


def _ptxas(text: str):
  """(kernel, stack/spill line, registers line) per entry in a -Xptxas -v
  log."""
  out, entry, props = [], None, ""
  for line in text.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if m:
      entry, props = m.group(1), ""
    elif entry and "bytes stack frame" in line:
      props = line.strip()
    elif entry and "Used" in line and "registers" in line:
      out.append((entry, props, line.split(":", 1)[1].strip()))
      entry = None
  return out


if __name__ == "__main__":
  sys.exit(main())
