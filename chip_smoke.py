"""Drive the PyTorch/CUDA port's FF eval render on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code
is non-zero and the last line below is never printed):

  0. the card's name and power limit (nvidia-smi); TF32 off;
  1. build the three CUDA kernels from csrc/ (one nvcc each, in parallel);
  2. hold each kernel against its plain PyTorch twin at the main path's
     shapes (K2/K3 at both the coarse and the fine stage) and time kernel,
     twin and (K1) the library call;
  3. render one 1024-ray chunk (64+64 samples, 7+11 views, 288×512
     sources, bf16) with launch counters zeroed just before and read just
     after, compare its coarse and fine rgb with the plain path, and time
     it;
  4. render full 288×512 frames (featmap encode included, chunk 4096): one
     warm-up, then the mean and spread of three;
  5. print the kernels line, then the result line.

Weights are random, from a seed.  Needs one card and no network.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
SEED = 0


def _card() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def _nbytes(*tensors) -> int:
  return sum(t.numel() * t.element_size() for t in tensors)


def _bound_ms(n_bytes: int, n_ops: float, peak_ops: float):
  t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
  return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


def _compare_raw(name, got, want, atol, rtol):
  """Kernel raw [R,S,4] vs plain twin: -1e9 sigma entries must coincide
  exactly; everything else within atol + rtol·|want|."""
  fill_got, fill_want = got[..., 3] <= -1e8, want[..., 3] <= -1e8
  if not torch.equal(fill_got, fill_want):
    raise AssertionError(f"{name}: -1e9 sigma entries differ "
                         f"({int((fill_got != fill_want).sum())} points)")
  keep = ~fill_want
  g = torch.cat([got[..., :3].reshape(-1), got[..., 3][keep]])
  w = torch.cat([want[..., :3].reshape(-1), want[..., 3][keep]])
  if not torch.isfinite(g).all():
    raise AssertionError(f"{name}: non-finite output")
  err = (g - w).abs()
  bad = err > atol + rtol * w.abs()
  if bad.any():
    raise AssertionError(f"{name}: {int(bad.sum())} of {g.numel()} values "
                         f"outside atol {atol} rtol {rtol}; max abs err "
                         f"{float(err.max())}")
  return float(err.max())


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    return 1
  from dynibar_tpu_torch.config import RenderSettings
  from dynibar_tpu_torch.data.ray_batch import synthetic_ff_batch
  from dynibar_tpu_torch.models.dynibar import FFModel
  from dynibar_tpu_torch.ops import agg, build, sample
  from dynibar_tpu_torch.render import render_rays as rr
  from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                     render_image_ff)
  from dynibar_tpu_torch.utils.device import resolve_device, to_device

  # ---- 0: the card --------------------------------------------------------
  card = _card()
  dev = resolve_device(None)          # also turns TF32 off
  print(f"card: {card}", flush=True)

  # ---- 1: build -----------------------------------------------------------
  t0 = time.perf_counter()
  secs = build.build()
  print(f"build: {time.perf_counter() - t0:.1f} s "
        f"({ {k: round(v, 1) for k, v in secs.items()} })", flush=True)

  h, w, chunk = 288, 512, 1024
  cfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                       num_views_static=11, num_basis=6, inv_uniform=True,
                       compute_dtype="bfloat16")
  model = FFModel(cfg, num_frames=48, seed=SEED)
  rb = to_device(synthetic_ff_batch(cfg, n_rays=chunk, h=h, w=w,
                                    num_frames=48, seed=SEED,
                                    scanline=True), dev)
  with torch.no_grad():
    coarse, fine = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])

  # ---- 2: each kernel vs its plain twin at the main path's shapes ---------
  # both stages' inputs, from the plain path: the coarse stage's projections
  # and gathers, then importance-resampled depths from the plain coarse pass
  # and the fine stage's own projections and gathers
  with torch.no_grad():
    pts, z_vals, _ = rr.sampling.sample_along_ray(
        rb["ray_o"], rb["ray_d"], rb["depth_range"], cfg.n_samples,
        cfg.inv_uniform, det=True)
    ins_c = rr.stage_inputs(model, rb, coarse, cfg, "coarse", pts,
                            kernels=False)
    out_c, _, _, _ = rr._render_stage_ff(model, rb, coarse, cfg, "coarse",
                                         pts, z_vals, kernels=False)
    z_all = rr.sampling.importance_resample_z(
        z_vals, out_c["weights"], cfg.n_importance, cfg.inv_uniform, det=True)
    pts_f = z_all[..., None] * rb["ray_d"][:, None] + rb["ray_o"][:, None]
    ins = rr.stage_inputs(model, rb, fine, cfg, "fine", pts_f, kernels=False)
  results = {}

  # K1 at the fine stage's static feature gather: [11,72,128,32] bf16 maps
  with torch.no_grad():
    maps = fine[2].to(torch.bfloat16).contiguous()
    pix, _ = rr.proj.project_points(
        pts_f[None].expand((11,) + pts_f.shape), rb["static_src_cameras"])
    grid = (2.0 * pix / torch.tensor([w - 1.0, h - 1.0], device=dev)
            - 1.0).contiguous()
    rgbs = rb["static_src_rgbs"].to(torch.bfloat16).contiguous()
    max_err = 0.0
    for m in (maps, rgbs):                   # features and full-res RGB
      got = sample.sample_views(m, grid).float()
      want = sample.sample_views_plain(m, grid).float()
      err = (got - want).abs()
      # exact to bf16 rounding: at most one bf16 ulp (<= 2^-7 |x|) apart;
      # both interpolate in f32 and round once, in another order
      tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 1e-6
      if (err > tol).any():
        raise AssertionError(f"K1: {int((err > tol).sum())} values beyond "
                             f"one bf16 ulp; max {float(err.max())}")
      max_err = max(max_err, float(err.max()))
    v, r, s, c = grid.shape[0], grid.shape[1], grid.shape[2], maps.shape[-1]
    ms = _time_ms(lambda: sample.sample_views(maps, grid))
    plain_ms = _time_ms(lambda: sample.sample_views_plain(maps, grid))
    # library yardstick: grid_sample wants NCHW and a grid of the maps'
    # dtype, both prepared outside the timed call
    nchw = maps.permute(0, 3, 1, 2).contiguous()
    g4 = grid.reshape(v, r * s, 1, 2).to(maps.dtype)
    lib_ms = _time_ms(lambda: F.grid_sample(
        nchw, g4, mode="bilinear", padding_mode="zeros", align_corners=True))
    n_out = v * r * s * c
    bound, by = _bound_ms(_nbytes(maps, grid) + n_out * 2, 8.0 * n_out,
                          PEAK_F32_FLOPS)
    results["K1"] = dict(
        name="sample_views", route="cuda",
        source="dynibar_tpu_torch/csrc/sample.cu",
        replaces="dynibar_tpu/ops/pallas_sample.py:60",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms)

  # K2 / K3 at both stages (coarse S=64, fine S=128): bf16 kernel vs the
  # f32 module, at the bars the JAX package holds its Pallas kernels to
  # (tests/test_pallas_agg.py:80,90); timed at the fine stage
  for key, static, nets, stage_args, atol in (
      ("K2", True, (model.net_coarse_st, model.net_fine_st),
       (ins_c["st"], ins["st"]), 2e-2),
      ("K3", False, (model.net_coarse_dy, model.net_fine_dy),
       (ins_c["dy"], ins["dy"]), 1e-2)):
    with torch.no_grad():
      fused = (agg.fused_static_aggregator if static
               else agg.fused_dynamic_aggregator)
      errs = []
      for stage, net, args in zip(("coarse", "fine"), nets, stage_args):
        got = fused(net, *args)
        want = net(*args)
        torch.cuda.synchronize()
        errs.append(_compare_raw(f"{key} {stage}", got, want, atol, 2e-2))
      print(f"{key} max abs err coarse {errs[0]:.3g}, fine {errs[1]:.3g}",
            flush=True)
      err = max(errs)
      ms = _time_ms(lambda: fused(net, *args), iters=5)
      plain_ms = _time_ms(lambda: net(*args), iters=3, warmup=1)
      r, s, v, c = args[3 if static else 1].shape
      wts = agg.pack_weights(net, static)
      bound, by = _bound_ms(
          _nbytes(*[a for a in args if torch.is_tensor(a)], *wts[:2])
          + r * s * 4 * 4, agg.aggregator_flops(static, r, s, v, c),
          PEAK_BF16_FLOPS)
      results[key] = dict(
          name=("fused_static_aggregator" if static
                else "fused_dynamic_aggregator"), route="cuda",
          source=("dynibar_tpu_torch/csrc/static_agg.cu" if static
                  else "dynibar_tpu_torch/csrc/dynamic_agg.cu"),
          replaces=("dynibar_tpu/ops/pallas_agg.py:225" if static
                    else "dynibar_tpu/ops/pallas_agg.py:325"),
          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
          bound_by=by, library_ms=None)
  for key, res in results.items():
    print(f"{key} {res['name']}: {res['ms']:.3f} ms "
          f"(plain {res['plain_ms']:.3f} ms, library {res['library_ms']}, "
          f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}), "
          f"max abs err {res['max_abs_err']:.3g} [{card}]", flush=True)

  # ---- 3: one chunk through the main path ---------------------------------
  counters = (sample.sample_views, agg.fused_static_aggregator,
              agg.fused_dynamic_aggregator)
  for f in counters:
    f.launches = 0
  ret = rr.render_rays_mv(model, rb, coarse, fine, cfg)
  torch.cuda.synchronize()
  launches = {"K1": sample.sample_views.launches,
              "K2": agg.fused_static_aggregator.launches,
              "K3": agg.fused_dynamic_aggregator.launches}
  if launches != {"K1": 8, "K2": 2, "K3": 2}:
    raise AssertionError(f"main-path launches per chunk {launches}, "
                         "want 8/2/2")
  print(f"chunk launches: {launches}", flush=True)
  plain = rr.render_rays_mv(model, rb, coarse, fine, cfg, kernels=False)
  chunk_errs = {}
  for name in ("outputs_coarse_ref", "outputs_fine_ref"):
    rgb_k, rgb_p = ret[name]["rgb"], plain[name]["rgb"]
    if not torch.isfinite(rgb_k).all() or rgb_k.shape != (chunk, 3):
      raise AssertionError(f"chunk: {name} rgb not finite or misshapen")
    chunk_errs[name] = float((rgb_k - rgb_p).abs().max())
    if chunk_errs[name] > 3e-2:   # the bar of tests/test_pallas_agg.py:177
      raise AssertionError(f"chunk: kernel vs plain {name} rgb "
                           f"{chunk_errs[name]}")
  chunk_ms = _time_ms(lambda: rr.render_rays_mv(model, rb, coarse, fine, cfg),
                      iters=5)
  print(f"chunk: {chunk_ms:.2f} ms/chunk = {chunk * 1e3 / chunk_ms:.1f} rays/s,"
        f" rgb kernel vs plain max abs coarse "
        f"{chunk_errs['outputs_coarse_ref']:.3g}, fine "
        f"{chunk_errs['outputs_fine_ref']:.3g} [{card}]", flush=True)

  # ---- 4: one full frame --------------------------------------------------
  frame_rb = full_image_ray_batch(rb, rb["camera"])

  def one_frame():
    with torch.no_grad():
      c, f = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
    return render_image_ff(model, frame_rb, c, f, cfg, chunk_size=4096,
                           height=h, width=w)

  one_frame()                                  # warm-up
  torch.cuda.synchronize()
  secs_frame = []
  for _ in range(3):
    t0 = time.perf_counter()
    out = one_frame()
    secs_frame.append(time.perf_counter() - t0)
    rgb = out["outputs_fine_ref"]["rgb"]
    if rgb.shape != (h, w, 3) or not np.isfinite(rgb).all():
      raise AssertionError("frame: fine rgb not finite or misshapen")
  print(f"frame: {np.mean(secs_frame):.3f} s/frame at {h}x{w}, chunk 4096, "
        f"mean of {len(secs_frame)} after a warm-up (min "
        f"{min(secs_frame):.3f}, max {max(secs_frame):.3f}), "
        f"mask mean {float(out['outputs_fine_ref']['mask'].mean()):.3f} "
        f"[{card}]", flush=True)

  # ---- 5: result ----------------------------------------------------------
  kernels = []
  for key in ("K1", "K2", "K3"):
    res = dict(results[key])
    res["launches"] = launches[key]
    kernels.append(res)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(card, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
