"""Drive the PyTorch/CUDA port on one CUDA card: the FF eval render, the
FF fine-stage train step, the mono model's eval chunk and train step, the
monocular training CLI from an on-disk scene to checkpoints, the Nvidia
benchmark eval CLI on an on-disk scene, the mono render and serving
path (the HTTP server over the training CLI's checkpoint, the render
CLI), the FF training chain: the coarse-stage train step, then the
fine-stage training CLI on its snapshot, from an analytic scene on disk,
scene preprocessing: the camera and virtual-view CLIs from a
dynamic-video-depth output, then the training CLI on what they wrote,
the mesh (parallel/mesh.py) rehearsed on the one card, the mono
model's convergence run on the analytic scene, and the FF eval ladder at
trained weights.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code
is non-zero and the last line below is never printed):

  0. the card's name and power limit (nvidia-smi); TF32 off;
  1. build the seven CUDA libraries from csrc/ (one nvcc each, all at
     once); phase 16 runs while they build; K4s's, the longest, goes on
     building through phases 14 and 15 (run here, below) and phases 2 and
     2b until K4s's first launch in 2b,
     where each kernel's footprint and blocks per SM are printed;
  2. hold each eval kernel against its plain PyTorch twin at the main
     path's shapes (K2/K3 at both the coarse and the fine stage) and time
     kernel, twin and the bound; K1 as the main path launches it (both
     maps of the fine stage's 11 static views into rgb_feat in one
     launch) and on each map alone (features, full-resolution RGB), there
     also against F.grid_sample; K2/K3 at the fine stage also
     with their two launches' device ms (trunk_kernel, ray_kernel, from
     torch.profiler), the previous design's recorded ms and the bound;
     K2 with the rgb mask off (the eval configs' mask_rgb = 0) at both
     stages, on the stages' inputs and with a quarter of the source
     pixels black, at the same bars;
  2b. K2/K3 (no grad) at the train step's fine-stage shapes as in 2 (V =
     11, 7 and 6); hold the training kernels against their twins at those
     shapes, N_rand = 3072 rays: K2r/K3r forwards and the
     K5a/K5b, K4a/K4b backwards (V = 11 static, 7 and 6 dynamic) through
     the autograd Functions vs the f32 modules under autograd (run in
     512-ray slices), per tensor within twice the bf16 twin's error plus
     0.02, the anti-alias scalar per point and as a sum scaled by its
     terms; time fwd+bwd and each launch (K4b, and K4s below, also with
     its bound and the previous design's ms as recorded, not measured;
     K5d too, in phase 6a).
     The dynamic shapes also on the
     route "pallas": K3p (the K3 forward, no residuals) and the one-launch
     backward K4s at the same bars, K4s's gradients within a tenth of
     that bar of K4a + K4b's on the same inputs and cotangent (largest
     relative difference printed per tensor, and the split's own
     run-to-run difference where it is largest), each launch timed; and
     route "pallas" at S = 48 (the V = 7 inputs' first 48 samples: K4s
     masks a ray's last trunk block) at the same bars;
  3. render one 1024-ray chunk (64+64 samples, 7+11 views, 288×512
     sources, bf16) with launch counters zeroed just before and read just
     after, compare its coarse and fine rgb with the plain path, and time
     it;
  4. render full 288×512 frames (featmap encode included, chunk 4096): one
     warm-up, then the mean and spread of three;
  5. the fine-stage train step at N_rand 3072 (7 dynamic, 6 anchor, 11
     static views): launch counts of one step; kernel vs plain gradients
     per trainable group and the loss of the next step on the same batch
     (the plain fine aggregators in checkpointed 512-ray slices); s/step
     over 5 steps after 2 warm-ups and peak memory; 10 steps on one batch
     with a falling loss;
  6. the mono model at bench.py's width (64 samples, 9 dynamic, 10 anchor
     and 14 static views, 288×512 sources, 48 frames, bf16):
     a. K2 at V = 14 and K3 at V = 9 and 10 against their twins, and
        reported as in 2 at those shapes; the training kernels at the mono
        step's 3072 rays as in 2b: static V = 14 on both backward routes
        (K2r/K5a/K5b and K2r/K5a/K5c/K5d, K5d with its bound and the
        previous design's ms as recorded), dynamic V = 9 and V = 10 on
        both dynamic routes (K3r/K4a/K4b; a': K3p/K4s as in 2b, with four
        weight seeds);
     b. one 1024-ray eval chunk (is_train=False, det=True): launch counts,
        kernel vs plain rgb, rays/s;
     c. the mono train step at N_rand 3072 (schedule_weights(epoch=2)) on
        each route (pallas_split; static pallas_split3; c': dynamic
        pallas, K3p + K4s): launch counts of one step; kernel vs plain loss
        and per-group gradients (plain aggregators in checkpointed 512-ray
        slices) after one update, and on the other routes their gradients
        against pallas_split's from the same weights; s/step over 5 steps
        after 2 warm-ups and peak memory; 10 steps on one batch with a
        falling loss; one bootstrap step;
  8. the training CLI (cli/train.main) on the "pallas" route from a
     48-frame 288×512 scene written to a temporary directory: one
     bootstrap epoch and one phase-2 epoch of 48 steps each at N_rand
     3072, a checkpoint in phase 2, one full-frame training panel at the
     last step (K1-K3); s/step per phase, the panel's s/frame and the
     time the step loop spent getting batches from the data pipeline, as
     the CLI logs them; the CLI's panel function on a batch of the scene
     with the last checkpoint's weights held against a plain-path render
     of the same view (rgb within 3e-2); then a second run that resumes
     at the saved step with the saved parameters and runs one more epoch;
  9. the Nvidia eval CLI (cli/eval_nvidia.main) on
     configs_nvidia/eval_balloon1_long.txt (64 + 64 samples, 7 + 11
     views, bf16, mask_rgb = 0, mask_static, chunk 8192) over a 12-frame
     288×512 scene the port writes to a temporary directory (the seconds
     that took printed), one frame (--max_frames 1): 11 viewpoints, finite
     PSNR / SSIM in the three regions, LPIPS NaN (no weights), K1 / K2 /
     K3 launched 4 / 2 / 2 times per chunk, 18 chunks per viewpoint frame;
     s per viewpoint frame (the CLI's log: data, render, metrics), s for
     the frame of 11 viewpoints and peak memory; viewpoint 0 rendered
     again through the plain twins from the CLI's own inputs, rgb within
     3e-2, both PSNRs against the ground truth printed;
  10. the served mono frame: a SessionRegistry over phase 8's scene and
     last snapshot at configs/test_kid-running.txt's render settings (288×512,
     64 samples, 14 static and 9 dynamic views, mask_rgb 1, bf16, chunk
     8192; anti-alias pooling on, as phase 8 trained) behind make_server
     on 127.0.0.1 in a thread: GET /healthz and /meta, POST /render at frame
     24's own pose (npy) cold (feature maps encoded) then warm (a cache
     hit), the same at stride 4 with layer rgb_dy, POST /stream of a
     4-pose wander path (4 PNG parts, decoded by data/png.py); every
     status 200, K1 / K2 / K3 launched 36 / 18 / 18 times per full-frame
     request (18 chunks), cache hits 2 and misses 1 before the stream,
     every output finite; the frame's middle 8192-ray chunk rendered
     again from the session's template and feature maps through the
     kernels (equal to the served rows within 1e-3) and through the plain
     twins (rgb within 3e-2), and K2 alone on its static inputs (the
     phase 2 bar); then the render CLI (cli/render_monocular.main, the
     stabilization path, video_out "") on the kid-running config as it is
     (anti-alias pooling off) over a 12-frame 288×512 scene with a seeded
     MonoModel(num_frames=12) snapshot: 12 PNGs of 272×482 (the 3% crop),
     the same launches per frame, its first frame's middle chunk against
     the plain path and K2 (anti-alias off) against its twin; cold and
     warm s per request, s per streamed frame, the CLI's s/frame, cache
     hits and misses, peak memory and the phase's seconds;
  11. the FF coarse stage (64 samples, 7 dynamic, 6 anchor and 11 static
     views, 288×512 sources, bf16, N_rand 3072):
     a. the training kernels at the coarse step's shapes as in 2b (S =
        64; static V = 11 on pallas_split and pallas_split3, and at
        mask_rgb = 0 on pallas_split; dynamic V = 7 and 6 on pallas_split
        and pallas), each with its ms and bound;
     b. ff_coarse_train_step on each backward route: the launches of one
        step (as the mono step's: K2r 1, K5a 1, K5b 1 or K5c 1 + K5d 1,
        K3r 2, K4a 2, K4b 2 or K3p 2, K4s 2), kernel vs plain loss and
        per-group gradients (plain coarse aggregators in checkpointed
        512-ray slices), s/step over 5 steps after 2 warm-ups and peak
        memory, 10 steps on one batch with a falling loss, the fine groups
        bit-identical;
     c. the chain from disk at configs_nvidia/eval_balloon1_long.txt
        (mask_rgb = 0, mask_static): ConsistentScene(24 frames,
        288×512).write_nvidia into a temporary directory, 48 coarse steps
        from a PrefetchPipeline over NvidiaSceneData and a snapshot, then
        cli/train_ff.main on that snapshot for one epoch (24 steps); the
        CLI's coarse groups equal the coarse run's bit for bit, a falling
        loss in each stage (the mean of the first steps against the last);
        s/step and pipeline wait of each stage, the CLI's launches, and the
        two held-out views' crop-3% PSNR before and after the fine stage
        (printed, not gated);
  12. preprocessing (no kernel of its own: the splat is plain PyTorch on
     the card, as the JAX package's is an XLA scatter):
     a. a 48-frame 288×512 ConsistentScene's masks and flows in the
        monocular layout, its images/ replaced by 576×1024 renders (the
        focal doubled), and a dynamic-video-depth output (one npz per
        frame: depth [1,1,144,256] of the scene, K transposed, cam_c2w),
        written by 8 worker processes;
     b. cli/save_monocular_cameras.main (host) and
        cli/render_source_vv.main on the card at --height 288, 8 virtual
        views per frame: the poses against the scene's cameras (1e-9) and
        the bounds against the depth percentiles (exact); s/frame of each
        CLI, the virtual views' PhaseTimer split (read, filters, geometry,
        splat, erode, write), peak memory; one frame's splats inside
        utils/profiling.trace, whose Chrome trace must name the
        softmax_splat region;
     c. frames 0 and 47's splats again on the card and on the CPU (rgb
        within 2e-3 on the 0-255 scale, alpha within 1e-5), the CLI's
        PNGs equal to the CPU's but at ties (the CPU's alpha within 1e-5
        of 0.5, spread by the erosion, or a value within 1e-3 of a
        truncation step), the ties where the f64 splat is not on the step
        under 0.1% of the pixels; each view's masked PSNR against the
        scene's exact render at its pose (printed, not gated);
     d. cli/train.main on the preprocessed folder on the default routes
        at phase 8's settings, one bootstrap epoch of 48 steps: a finite
        loss whose mean over the last 12 steps is below the first 12's,
        launches K2r, K5a, K5b and K3r once per step and nothing else;
        s/step and pipeline wait from metrics.jsonl;
  13. the mesh on the one card (run after phase 10, over phase 8's scene
     and last snapshot; the kernels load from phase 1's build):
     a. two spawned ranks share the card over gloo: the mono step at
        phase 6's shapes (N_rand 3072 global, 1536 rays per rank, S = 64)
        as phase 6 runs it (bf16 sampling, pallas_split) and with the
        sampling in f32 on routes pallas_split and pallas, and the FF fine
        step at phase 5's shapes (f32 sampling); three steps each, every
        one against a one-card step from the same state on the same batch
        and generator state (rank 0), which also runs twice to print what
        one card differs from itself by: the loss within 1e-5 relative,
        each group's gradient within 1e-4 relative norm (at bf16 sampling
        the feature nets' within 2e-3: each rank rounds its part of the
        feature maps' gradient to bf16, one card the whole), the ranks'
        parameters bit-identical after the three steps; the launches per
        rank and step, s/step per rank (printed, not a target: two ranks
        time-slice one card);
     b. one 288x512 FF eval frame at the eval config's settings (64 + 64,
        bf16, mask_rgb = 0, chunk 8192) over the two ranks against the
        one-card frame, and one served mono frame (phase 10's settings,
        frame 24's pose, npy) through make_server on rank 0 with rank 1
        following, then the same at stride 4 with rgb_dy: every status
        200, the follower's two renders, the full frame against the
        one-card render of the same camera; max abs differences printed
        and held inside K2/K3's bar (2e-2); rank 0's launches;
     c. cli/train under torchrun --standalone --nproc_per_node 1 with
        mesh_shape auto: one bootstrap epoch (48 steps at N_rand 3072) on
        phase 8's scene over NCCL (the mesh's init line), finite losses,
        s/step from its log; the phase's seconds;
  14. the mono convergence run (scripts/port_mono_convergence.run, run
     right after the build, while K4s's library builds: its path launches
     no K4s) at its production configuration (N_rand 3072, 64
     samples, 7 source and 3 virtual views, bf16, the default routes) on
     a 24-frame 96×144 ConsistentScene with the compressed schedule
     (--clip 1 --init_decay_epoch 10): 300 steps, 120 of them the
     bootstrap, an eval of the train view and the two held-out views
     every 150 steps; (a) finite losses, the mean of the full phase's last
     25 below its first 25's; (b) the train view's crop-3% PSNR above its
     init; (c) every full-phase step launches the default routes' mono
     step (K2r 1, K5a 1, K5b 1, K3r 2, K4a 2, K4b 2), every bootstrap step
     K2r, K5a, K5b and K3r once, the evals K1 / K2 / K3 2 / 1 / 1 per
     4608-ray chunk; (d) the first, middle and last 1024-ray chunks of
     both held-out views at the trained weights through the kernels
     against the plain path (rgb within 3e-2); K2 and K3 alone on each
     chunk's inputs: finite, their -1e9 fills exact, and within the
     bf16-twin bar of the JAX package (tests/test_pallas_agg.py:93-104):
     max|kernel - f32 module| <= 2 max|bf16 twin - f32 module| + 1e-3,
     apart for the colours and for the densities that are not fills (the
     twin: utils/kernel_check.bf16_twin); both errors, the worst kernel /
     bar ratio and the counts outside their phase 2 bars printed (those
     bars hold at random weights);
     the schedule's transitions, the curve, the held-out rise (printed,
     not gated), s/step, peak memory and the phase's seconds;
  15. the FF eval ladder at trained weights (run right after phase 14,
     while K4s's library builds: the FF default routes launch no K4s):
     scripts/port_ff_convergence.run on a 24-frame 96×144 ConsistentScene
     in the 12-camera layout, 100 coarse + 100 fine steps on the default
     routes (its +5 dB gate, set for 1500 + 2500 steps, printed, not
     gated: s/step per stage, the rises and the run's launches), then the
     three rungs of scripts/port_eval_ff_synthetic.run on its phase-B
     snapshot over frame 3's 11 viewpoints (64 + 64 samples, 7 + 11 views,
     chunk 4608): exact_f32 (the f32 modules), exact_bf16 (bf16 sampling,
     the aggregators' bf16 twin) and fused_bf16 (K1-K3, the eval CLI's
     path); every rung's tables finite and 11 viewpoints rendered; the
     fused rung launches K1 / K2 / K3 4 / 2 / 2 per chunk (3 chunks a
     viewpoint), the others none; the rungs' tables, the deltas between
     rungs in dB and SSIM, s per viewpoint frame and peak memory; the
     first, middle and last 1024-ray chunks of frame 3's viewpoints 0 and
     6 through the kernels against the plain path (both stages' rgb
     within 3e-2; their distances to the bf16 twins' chunk, and the
     twins' to the plain path's, printed), and K2 and K3 alone at both
     stages on each chunk's inputs as in 14 (finite, fills exact, the
     bf16-twin bar gated, the phase 2 bars counted); the phase's seconds;
  16. the host decoder and flow IO (run while nvcc builds in phase 1; no
     hand kernel): build csrc/image_loader.cc with the host compiler;
     write 48 288×512 frames as PNG and as JPEG (data/jpeg.py's writer);
     every frame from llff.read_image equal byte for byte to
     decoder="numpy"; the native batch at 4 threads equal to the
     single-file path broadcast and scaled; a 144×256 batch finite, in
     [0, 1] and equal to _resize_to_float; a missing file raising IOError
     naming it; warp_flow on the card within 1e-6 of the CPU's at 288×512
     with a fractional flow; decode ms per frame of each decoder and
     format on 1 and 4 threads (nvcc runs beside it) and the phase's
     seconds.  Phase 8 prints its pipeline wait per step over the CLI's
     first 10 steps, its frames now decoded natively;
  7. print the total seconds, the kernels line (13 kernels; K1 with its single-map times, K2
     and K3 with their forward reports of 2, 2b and 6a; K1-K3 with their
     launches per eval viewpoint frame and per served frame, K2 with its
     mask_rgb = 0 and anti-alias-off errors; each training kernel with its
     ms, bound and launches at the FF coarse step's shapes (phase 11) and
     its launches in the chain's CLI run; every kernel with its launches
     in phase 12's training run, as mesh_launches rank 0's per step or
     frame in phase 13, its launches in phase 14's run and phase 15's
     convergence run, and K1-K3 with the fused rung's per viewpoint
     frame),
     the card line, then the result line.

Weights are random, from a seed.  Needs one card and no network.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
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
RAY_SIDE_LAYERS = ("geometry_fc", "ray_attention", "out_geometry_fc",
                   "rgb_fc", "ref_pts_fc")
TRAIN_SOURCES = {
    "K2r": "dynibar_tpu_torch/csrc/agg_fwd.cuh",
    "K3r": "dynibar_tpu_torch/csrc/agg_fwd.cuh",
    "K5a": "dynibar_tpu_torch/csrc/ray_bwd_sm90.cuh",
    "K5b": "dynibar_tpu_torch/csrc/trunk_bwd_sm90.cuh",
    "K5c": "dynibar_tpu_torch/csrc/static_agg_bwd3.cu",
    "K5d": "dynibar_tpu_torch/csrc/static_agg_bwd3.cu",
    "K4a": "dynibar_tpu_torch/csrc/ray_bwd_sm90.cuh",
    "K4b": "dynibar_tpu_torch/csrc/trunk_bwd.cuh",
    "K3p": "dynibar_tpu_torch/csrc/agg_fwd.cuh",
    "K4s": "dynibar_tpu_torch/csrc/dynamic_agg_bwd1.cu"}
REPLACES = {
    "K2r": "dynibar_tpu/ops/pallas_agg.py:225",
    "K3r": "dynibar_tpu/ops/pallas_agg.py:325",
    "K5a": "dynibar_tpu/ops/pallas_agg_bwd.py:879",
    "K5b": "dynibar_tpu/ops/pallas_agg_bwd.py:1109",
    "K5c": "dynibar_tpu/ops/pallas_agg_bwd.py:1328",
    "K5d": "dynibar_tpu/ops/pallas_agg_bwd.py:1484",
    "K4a": "dynibar_tpu/ops/pallas_agg_bwd.py:514",
    "K4b": "dynibar_tpu/ops/pallas_agg_bwd.py:733",
    "K3p": "dynibar_tpu/ops/pallas_agg.py:925",
    "K4s": "dynibar_tpu/ops/pallas_agg_bwd.py:163"}
WRAPPERS = {
    "K2r": "static_forward_residuals", "K5a": "static_backward_ray",
    "K5b": "static_backward_trunk", "K5c": "static_backward_trunk3",
    "K5d": "static_backward_inmlp", "K3r": "dynamic_forward_residuals",
    "K4a": "dynamic_backward_ray", "K4b": "dynamic_backward_trunk",
    "K3p": "dynamic_forward_primal", "K4s": "dynamic_backward_single"}
TRAIN_LAUNCHES = {"K1": 2, "K2": 1, "K3": 1, "K2r": 1, "K5a": 1, "K5b": 1,
                  "K3r": 2, "K4a": 2, "K4b": 2, "K5c": 0, "K5d": 0, "K3p": 0,
                  "K4s": 0}
# the mono step's routes: (static fused_st_bwd_impl, dynamic fused_bwd_impl)
MONO_ROUTES = {"pallas_split": ("pallas_split", "pallas_split"),
               "pallas_split3": ("pallas_split3", "pallas_split"),
               "pallas": ("pallas_split", "pallas")}
MONO_LAUNCHES = {
    "pallas_split": {"K1": 0, "K2": 0, "K3": 0, "K2r": 1, "K5a": 1,
                     "K5b": 1, "K3r": 2, "K4a": 2, "K4b": 2, "K5c": 0,
                     "K5d": 0, "K3p": 0, "K4s": 0},
    "pallas_split3": {"K1": 0, "K2": 0, "K3": 0, "K2r": 1, "K5a": 1,
                      "K5b": 0, "K3r": 2, "K4a": 2, "K4b": 2, "K5c": 1,
                      "K5d": 1, "K3p": 0, "K4s": 0},
    "pallas": {"K1": 0, "K2": 0, "K3": 0, "K2r": 1, "K5a": 1, "K5b": 1,
               "K3r": 0, "K4a": 0, "K4b": 0, "K5c": 0, "K5d": 0, "K3p": 2,
               "K4s": 2}}
# the FF coarse step's launches per route: one static and two dynamic
# aggregators under autograd, as the mono step
COARSE_LAUNCHES = MONO_LAUNCHES
WEIGHT_SEEDS = range(4)
K4S_LIB = "dynamic_agg_bwd1"
TRUNK_LAYERS = ("base_fc", "vis_fc", "vis_fc2", "s")


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


# K2 / K3 before their Hopper redesign (mma.sync with weight fragments
# from L2 one k-step ahead, the scalar attention): trunk_kernel +
# ray_kernel device ms per launch pair at each forward shape, the mean of
# two turns of scripts/port_profile.py --forward (random inputs) in one
# call on an H100 80GB HBM3 at 700 W
FWD_PARENT_MS = {
    "K2 FF eval fine R=1024 S=128 V=11": 11.4645,
    "K3 FF eval fine R=1024 S=128 V=7": 4.9575,
    "K2 FF step R=3072 S=128 V=11": 33.520,
    "K3 FF step R=3072 S=128 V=7": 14.239,
    "K3 FF step R=3072 S=128 V=6": 13.772,
    "K2 mono step R=3072 S=64 V=14": 20.5025,
    "K3 mono step R=3072 S=64 V=9": 7.528,
    "K3 mono step R=3072 S=64 V=10": 8.1015}
FWD_SOURCE = "dynibar_tpu_torch/csrc/agg_fwd.cuh"
# K4b, K4s and K5d before their Hopper redesign (K4b, K5d: their first
# bodies, row-major weights one k-step ahead; K4s: its ray phase on the
# pre-Hopper ray body): ms per call at the training shapes, as recorded on
# an H100 80GB HBM3 at 700 W, by label: (ms, the script that measured it)
BWD_PARENT_MS = {
    ("K4b", "dynamic V=7"): (35.33, "chip_smoke.py, CUDA events"),
    ("K4b", "dynamic V=6"): (29.88, "scripts/port_profile.py --backward, "
                             "device time, two runs"),
    ("K4b", "mono dynamic V=9"): (23.27, "chip_smoke.py, CUDA events"),
    ("K4b", "mono dynamic V=10"): (25.57, "scripts/port_profile.py "
                                   "--backward, device time, two runs"),
    ("K4s", "dynamic V=7"): (96.61, "chip_smoke.py, CUDA events"),
    ("K4s", "mono dynamic V=9"): (57.15, "chip_smoke.py, CUDA events"),
    ("K4s", "mono dynamic V=10"): (61.83, "chip_smoke.py, CUDA events"),
    ("K5d", "mono static V=14 split3"): (15.39, "chip_smoke.py, CUDA "
                                         "events")}


def _redesign_report(card, key, label, ms, bound):
  """A redesigned backward's ms per call beside its bound and, printed
  only, the previous design's recorded ms (BWD_PARENT_MS)."""
  parent, source = BWD_PARENT_MS.get((key, label), (None, ""))
  print(f"{key} {label}: {ms:.3f} ms per call; bound {bound[0]:.4f} ms by "
        f"{bound[1]} [{card}]; previous design "
        + ("not recorded" if parent is None else
           f"{parent:.3f} ms as recorded, not measured in this run "
           f"({source}, H100 80GB HBM3 at 700 W)"), flush=True)


def _kernel_split(fn, iters: int = 3):
  """Device ms per call of the forward's two launches (trunk_kernel,
  ray_kernel), from torch.profiler over `iters` calls after one."""
  fn()
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  out = {"trunk": 0.0, "ray": 0.0}
  for ev in prof.key_averages():
    if not str(ev.device_type).endswith("CUDA"):
      continue
    us = getattr(ev, "self_device_time_total",
                 getattr(ev, "self_cuda_time_total", 0.0))
    for part in out:
      if f"agg::{part}_kernel" in ev.key:
        out[part] += us / iters / 1e3
  return out


def _forward_bound(static, net, args):
  from dynibar_tpu_torch.ops import agg
  r, s, v, c = args[3 if static else 1].shape
  wts = agg.pack_weights(net, static)
  return _bound_ms(_nbytes(*[a for a in args if torch.is_tensor(a)], *wts[:2])
                   + r * s * 4 * 4, agg.aggregator_flops(static, r, s, v, c),
                   PEAK_BF16_FLOPS)


def _forward_report(card, label, static, net, args):
  """K2 or K3 (no grad) at one shape: ms per call, its launches' split
  and the bound, printed and returned. The previous design's ms
  (FWD_PARENT_MS, recorded, not measured here) is printed, not returned."""
  from dynibar_tpu_torch.ops import agg
  fused = (agg.fused_static_aggregator if static
           else agg.fused_dynamic_aggregator)
  key = "K2" if static else "K3"
  with torch.no_grad():
    ms = _time_ms(lambda: fused(net, *args), iters=5)
    split = _kernel_split(lambda: fused(net, *args))
  bound, by = _forward_bound(static, net, args)
  parent = FWD_PARENT_MS.get(f"{key} {label}")
  print(f"{key} {label}: {ms:.3f} ms per call; trunk_kernel "
        f"{split['trunk']:.3f} + ray_kernel {split['ray']:.3f} ms; bound "
        f"{bound:.4f} ms by {by} [{card}]; previous design "
        + ("not recorded" if parent is None else
           f"{parent:.3f} ms as recorded, not measured in this run "
           "(scripts/port_profile.py --forward, random inputs, H100 80GB "
           "HBM3 at 700 W)"), flush=True)
  return dict(ms=ms, trunk_ms=split["trunk"], ray_ms=split["ray"],
              bound_ms=bound)


def _k1_check(name, got, want):
  """K1 vs its twin: at most one bf16 ulp apart (both interpolate in f32
  and round once, in another order).  Returns the largest difference."""
  got, want = got.float(), want.float()
  err = (got - want).abs()
  tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 1e-6
  if (err > tol).any():
    raise AssertionError(f"{name}: {int((err > tol).sum())} values beyond "
                         f"one bf16 ulp; max {float(err.max())}")
  return float(err.max())


def _sampler_report(card, rgbs, feats, grid):
  """K1 at one view set's call: the main path's fused launch (both maps
  into rgb_feat [R,S,V,3+C]) and the single-map entry on each map, each
  held to its twin and timed beside its twin, its bound and (one map)
  F.grid_sample.  Returns K1's entry of the kernels line."""
  from dynibar_tpu_torch.ops import sample
  v, r, s = grid.shape[:3]
  err = _k1_check("K1 fused", sample.sample_views_pair(rgbs, feats, grid),
                  sample.sample_views_pair_plain(rgbs, feats, grid))
  n_out = r * s * v * (rgbs.shape[-1] + feats.shape[-1])
  bound, by = _bound_ms(_nbytes(rgbs, feats, grid) + n_out *
                        rgbs.element_size(), 8.0 * n_out, PEAK_F32_FLOPS)
  out = dict(
      name="sample_views_pair", route="cuda",
      source="dynibar_tpu_torch/csrc/sample.cu",
      replaces="dynibar_tpu/ops/pallas_sample.py:60", max_abs_err=err,
      ms=_time_ms(lambda: sample.sample_views_pair(rgbs, feats, grid)),
      plain_ms=_time_ms(lambda: sample.sample_views_pair_plain(rgbs, feats,
                                                               grid)),
      bound_ms=bound, bound_by=by, library_ms=None, single_map={})
  print(f"K1 fused ([{r},{s},{v},{rgbs.shape[-1] + feats.shape[-1]}] from "
        f"{tuple(rgbs.shape)} and {tuple(feats.shape)} {rgbs.dtype}): "
        f"{out['ms']:.4f} ms (plain {out['plain_ms']:.4f}, bound "
        f"{bound:.4f} ms by {by}), max abs err {err:.3g} [{card}]",
        flush=True)
  for name, m in (("features", feats), ("rgb", rgbs)):
    err = _k1_check(f"K1 {name}", sample.sample_views(m, grid),
                    sample.sample_views_plain(m, grid))
    # library yardstick: grid_sample wants NCHW and a grid of the maps'
    # dtype, both prepared outside the timed call
    nchw = m.permute(0, 3, 1, 2).contiguous()
    g4 = grid.reshape(v, r * s, 1, 2).to(m.dtype)
    n_m = v * r * s * m.shape[-1]
    bound, by = _bound_ms(_nbytes(m, grid) + n_m * m.element_size(),
                          8.0 * n_m, PEAK_F32_FLOPS)
    d = dict(ms=_time_ms(lambda: sample.sample_views(m, grid)),
             plain_ms=_time_ms(lambda: sample.sample_views_plain(m, grid)),
             library_ms=_time_ms(lambda: F.grid_sample(
                 nchw, g4, mode="bilinear", padding_mode="zeros",
                 align_corners=True)),
             bound_ms=bound, bound_by=by, max_abs_err=err)
    out["single_map"][name] = d
    out["max_abs_err"] = max(out["max_abs_err"], err)
    print(f"K1 single map ({name}, [{v},{r},{s},{m.shape[-1]}]): "
          f"{d['ms']:.4f} ms (plain {d['plain_ms']:.4f}, F.grid_sample "
          f"{d['library_ms']:.4f}, bound {bound:.4f} ms by {by}) [{card}]",
          flush=True)
  return out


def _counters():
  """Every kernel wrapper's launch counter, by kernel id."""
  from dynibar_tpu_torch.ops import agg, sample
  out = {"K1": sample.sample_views, "K2": agg.fused_static_aggregator,
         "K3": agg.fused_dynamic_aggregator}
  out.update({k: getattr(agg, name) for k, name in WRAPPERS.items()})
  return out


def _zero_counts():
  for f in _counters().values():
    f.launches = 0


def _read_counts():
  return {k: f.launches for k, f in _counters().items()}


def _check_training_kernels(card, label, static, net, args, cot,
                            bwd="pallas_split"):
  """One aggregator's training kernels at the main path's ray count vs its
  twins (kernel_check, 512-ray slices): the forward, every input and
  weight gradient within its bar; fwd+bwd and each launch timed.  Returns
  {kernel id: result dict}, without launch counts."""
  from dynibar_tpu_torch.ops import agg
  from dynibar_tpu_torch.utils import kernel_check as kc
  if static:
    keys = ("K2r", "K5a") + (("K5c", "K5d") if bwd == "pallas_split3"
                             else ("K5b",))
  else:
    keys = ("K3r", "K4a", "K4b")
  r, s_, v, c = args[3 if static else 1].shape
  out_k, out_f, g_k, g_f, g_b = kc.all_grads(net, static, args, cot, bwd=bwd)
  torch.cuda.synchronize()
  fwd_err = _compare_raw(f"{keys[0]} ({label})", out_k, out_f,
                         2e-2 if static else 1e-2, 2e-2)
  errs = kc.grad_errors(g_k, g_f, g_b)
  kc.check_grad_errors(errs, f"{label} backward")
  fb_ms = _time_ms(lambda: kc.aggregator_grads(net, static, args, cot,
                                               "kernel", bwd=bwd),
                   iters=3, warmup=1)
  plain_fb_ms, plain_fwd_ms = _plain_ms(net, args, cot, static)
  # each launch on its own, CUDA events around the wrapper
  with torch.no_grad():
    if static:
      reffeat = agg._reffeat(net, args[1])
      fwd = lambda: agg.static_forward_residuals(
          net, args[0], reffeat, args[2], args[3], args[4], args[5])
      ray = agg.static_backward_ray
    else:
      dirfeat, dirpe = agg._dir_inputs(net, args[2], args[4])
      fwd = lambda: agg.dynamic_forward_residuals(
          net, args[0], dirfeat, dirpe, args[1], args[3])
      ray = agg.dynamic_backward_ray
    times = {keys[0]: _time_ms(fwd, iters=5)}
    _, ws = fwd()
    slabs, nblk, w_total = agg._slabs(cot.device,
                                      agg.pack_weights(net, static))
    times[keys[1]] = _time_ms(lambda: ray(net, ws, cot, slabs, nblk,
                                          w_total), iters=5)
    dx, dmisc = ray(net, ws, cot, slabs, nblk, w_total)[:2]
    if bwd == "pallas_split3" and static:
      times["K5c"] = _time_ms(lambda: agg.static_backward_trunk3(
          net, ws, dx, dmisc, slabs, nblk, w_total), iters=5)
      drf, d_dot, _ = agg.static_backward_trunk3(net, ws, dx, dmisc, slabs,
                                                 nblk, w_total)
      times["K5d"] = _time_ms(lambda: agg.static_backward_inmlp(
          net, ws, drf, dmisc, d_dot, slabs, nblk, w_total), iters=5)
      del drf, d_dot
    else:
      trunk = (agg.static_backward_trunk if static
               else agg.dynamic_backward_trunk)
      times[keys[2]] = _time_ms(lambda: trunk(net, ws, dx, dmisc, slabs,
                                              nblk, w_total), iters=5)
  p = r * s_
  f_trunk, f_ray = agg.aggregator_flop_parts(static, r, s_, v, c)
  f_in = agg.static_inmlp_flops(r, s_, v, c) if static else 0
  w_bytes = _nbytes(*agg.pack_weights(net, static)[:2])
  rf_bytes = _nbytes(ws["rf"]) if static else 0
  res_bytes = _nbytes(*[ws[k] for k in ("x", "vm", "gf")]) + rf_bytes
  in_bytes = _nbytes(*[t for k, t in ws.items()
                       if k not in ("x", "vm", "gf", "rf", "nv")])
  d_ray = v * p * (256 + 32)                   # d_x bf16, d_misc f32
  out_bytes = p * v * 4 * (c + 10) + p * 4 * (3 + c + 1)
  bounds = {
      keys[0]: _bound_ms(in_bytes + w_bytes + res_bytes + p * 16,
                         f_trunk + f_ray, PEAK_BF16_FLOPS),
      keys[1]: _bound_ms(res_bytes - rf_bytes + p * 16 + w_bytes + d_ray,
                         3 * f_ray, PEAK_BF16_FLOPS)}
  if "K5c" in keys:
    st_in = _nbytes(ws["rgb_feat"], ws["ray_diff"], ws["mask"])
    drf_bytes = v * p * 2 * c * 4
    bounds["K5c"] = _bound_ms(st_in + rf_bytes + d_ray + w_bytes + drf_bytes
                              + v * p * 4 + p * 4, 3 * (f_trunk - f_in),
                              PEAK_BF16_FLOPS)
    bounds["K5d"] = _bound_ms(
        _nbytes(ws["pts"], ws["reffeat"], ws["ray_diff"], ws["src_pl"])
        + drf_bytes + v * p * (32 + 4) + w_bytes + out_bytes - p * 4,
        3 * f_in, PEAK_BF16_FLOPS)
  else:
    bounds[keys[2]] = _bound_ms(in_bytes + d_ray + w_bytes + rf_bytes
                                + out_bytes, 3 * f_trunk, PEAK_BF16_FLOPS)

  def side(name):               # which launch produced this gradient
    if name.startswith("input."):
      if not static:
        return 1 if name in ("input.ray_dir", "input.pts") else 2
      return len(keys) - 1
    layer = name.split(".")[0]
    if layer in RAY_SIDE_LAYERS:
      return 1
    if "K5c" in keys and layer in TRUNK_LAYERS:
      return 2
    return len(keys) - 1

  print(f"{label}: fwd+bwd {fb_ms:.3f} ms (plain f32 {plain_fb_ms:.3f} ms, "
        f"plain fwd {plain_fwd_ms:.3f} ms); "
        + ", ".join(f"{k} {times[k]:.3f} ms" for k in keys)
        + f"; forward max abs err {fwd_err:.3g} [{card}]", flush=True)
  print(f"{label}: per launch ms / bound ms (bound's share): "
        + ", ".join(f"{k} {times[k]:.3f} / {bounds[k][0]:.3f} "
                    f"({100 * bounds[k][0] / times[k]:.1f}%)" for k in keys)
        + f" [{card}]", flush=True)
  if not static:
    _redesign_report(card, "K4b", label, times["K4b"], bounds["K4b"])
  elif "K5d" in keys:
    _redesign_report(card, "K5d", label, times["K5d"], bounds["K5d"])
  worst = sorted(errs.items(), key=lambda kv: kv[1][0] - kv[1][2])[-3:]
  print(f"{label}: gradient ratios closest to their bars (kernel, bf16 "
        f"twin, bar): {[(n, [round(x, 4) for x in e]) for n, e in worst]}",
        flush=True)
  if "s" in errs:
    print(f"{label}: anti-alias s (kernel, bf16 twin, bar): sum scaled by "
          f"its terms {[round(x, 5) for x in errs['s']]}, per point "
          f"{[round(x, 4) for x in errs['s.per_point']]}; per-point error "
          f"coherence kernel "
          f"{kc.error_coherence(g_k['s.per_point'], g_f['s.per_point']):.3f}"
          f", twin "
          f"{kc.error_coherence(g_b['s.per_point'], g_f['s.per_point']):.3f}",
          flush=True)
  abs_err = {n: float((g_k[n].float() - g_f[n]).abs().max()) for n in errs}
  out = {}
  for idx, key in enumerate(keys):
    res = dict(name=WRAPPERS[key], route="cuda", source=TRAIN_SOURCES[key],
               replaces=REPLACES[key], ms=times[key],
               bound_ms=bounds[key][0], bound_by=bounds[key][1],
               library_ms=None, rays=r, samples=s_, views=v)
    if idx == 0:
      res.update(max_abs_err=fwd_err, plain_ms=plain_fwd_ms)
    else:
      # the gradient closest to its bar: (kernel, bf16 twin, bar) ratios
      mine = {n: e for n, e in errs.items() if side(n) == idx}
      name = max(mine, key=lambda n: mine[n][0] / mine[n][2])
      res.update(max_abs_err=max(abs_err[n] for n in mine),
                 worst_grad=[name] + list(mine[name]),
                 plain_ms=plain_fb_ms - plain_fwd_ms)
    out[key] = res
  return out


def _plain_ms(net, args, cot, static):
  """The f32 twin's fwd+bwd and forward ms (512-ray slices, autograd)."""
  from dynibar_tpu_torch.utils import kernel_check as kc
  fb = _time_ms(lambda: kc.aggregator_grads(net, static, args, cot, "f32"),
                iters=2, warmup=1)

  def plain_fwd():
    for i in range(0, cot.shape[0], kc.TWIN_RAYS):
      net(*[a[i:i + kc.TWIN_RAYS] for a in args])

  with torch.enable_grad():
    net.requires_grad_(True)
    fwd = _time_ms(plain_fwd, iters=2, warmup=1)
    net.requires_grad_(False)
  return fb, fwd


def _single_correctness(label, net, args, cot):
  """The "pallas" route (K3p forward, K4s backward) vs the twins at the
  kernel_check bars, and K4s's gradients vs K4a + K4b's (route
  "pallas_split") on the same inputs and cotangent: the same bf16
  products, the weight gradients summed by atomics in another order, so
  each within a tenth of its kernel_check bar (relative to the f32
  gradient's scale).  Not 1e-3 as at the card tests' few rays: a
  one-column bias (vis_fc2's last) sums ~200k per-point terms of both
  signs, and its f32 sum moved with the order by up to 2e-3 of its
  cancelled value between two runs of the split itself.  Returns the K3p error, the gradient errors and the
  largest relative difference from the split per tensor."""
  from dynibar_tpu_torch.utils import kernel_check as kc
  out_k, out_f, g_k, g_f, g_b = kc.all_grads(net, False, args, cot,
                                             bwd="pallas")
  torch.cuda.synchronize()
  fwd_err = _compare_raw(f"K3p ({label})", out_k, out_f, 1e-2, 2e-2)
  errs = kc.grad_errors(g_k, g_f, g_b)
  kc.check_grad_errors(errs, f"{label} K4s")
  _, g_split = kc.aggregator_grads(net, False, args, cot, "kernel",
                                   bwd="pallas_split")
  vs_split = {n: float((g_k[n].float() - g).abs().max())
              / max(float(g_f[n].abs().max()), 1e-30)
              for n, g in g_split.items()}
  bad = {n: e for n, e in vs_split.items() if not e <= 0.1 * errs[n][2]}
  if bad:
    raise AssertionError(f"{label}: K4s and K4a+K4b gradients differ: {bad}")
  # the split against itself: the atomics' order alone
  worst = max(vs_split, key=vs_split.get)
  _, g_again = kc.aggregator_grads(net, False, args, cot, "kernel",
                                   bwd="pallas_split")
  again = (float((g_again[worst] - g_split[worst]).abs().max())
           / max(float(g_f[worst].abs().max()), 1e-30))
  print(f"{label}: K4s vs K4a+K4b largest on {worst}: {vs_split[worst]:.3g}"
        f" of its scale; K4a+K4b run twice differ there by {again:.3g}",
        flush=True)
  abs_err = max(float((g_k[n].float() - g_f[n]).abs().max()) for n in errs)
  return fwd_err, errs, vs_split, abs_err


def _check_single_kernels(card, label, net, args, cot, seeds=()):
  """The "pallas" route's kernels at one shape (_single_correctness) with
  `net`'s weights and, for correctness only, with fresh nets from each of
  `seeds`; each launch timed.  Returns {"K3p": ..., "K4s": ...} result
  dicts without launch counts."""
  from dynibar_tpu_torch.models.aggregators import DynamicAggregator
  from dynibar_tpu_torch.ops import agg
  from dynibar_tpu_torch.utils import kernel_check as kc
  r, s_, v, c = args[1].shape
  fwd_err, errs, vs_split, abs_err = _single_correctness(label, net, args,
                                                         cot)
  for seed in seeds:
    torch.manual_seed(seed)
    fresh = DynamicAggregator(c - 3, s_, shift=net.shift).to(cot.device)
    _single_correctness(f"{label} weight seed {seed}", fresh, args, cot)
  fb_ms = _time_ms(lambda: kc.aggregator_grads(net, False, args, cot,
                                               "kernel", bwd="pallas"),
                   iters=3, warmup=1)
  plain_fb_ms, plain_fwd_ms = _plain_ms(net, args, cot, False)
  with torch.no_grad():
    dirfeat, dirpe = agg._dir_inputs(net, args[2], args[4])
    fwd = lambda: agg.dynamic_forward_primal(net, args[0], dirfeat, dirpe,
                                             args[1], args[3])
    times = {"K3p": _time_ms(fwd, iters=5)}
    _, ins = fwd()
    times["K4s"] = _time_ms(lambda: agg.dynamic_backward_single(net, ins,
                                                                cot), iters=5)
  p = r * s_
  f_trunk, f_ray = agg.aggregator_flop_parts(False, r, s_, v, c)
  packed = agg.pack_weights(net, False)
  w_bytes = _nbytes(*packed[:2])
  in_bytes = _nbytes(*ins.values())
  out_bytes = 4 * (p * 3 + r * 27 + p * v * c + p * c
                   + packed[0].numel() + packed[1].numel())
  # K4s: the backward of dynamic_bwd_kernel from the primal inputs, one
  # forward recomputed and two forwards' worth of backward, 3x the whole
  # forward (the design's second trunk pass is its own cost, not the bound)
  bounds = {"K3p": _bound_ms(in_bytes + w_bytes + p * 16, f_trunk + f_ray,
                             PEAK_BF16_FLOPS),
            "K4s": _bound_ms(in_bytes + w_bytes + p * 16 + out_bytes,
                             3 * (f_trunk + f_ray), PEAK_BF16_FLOPS)}
  worst = max(errs, key=lambda n: errs[n][0] / errs[n][2])
  print(f"{label}: pallas route fwd+bwd {fb_ms:.3f} ms (plain f32 "
        f"{plain_fb_ms:.3f} ms, plain fwd {plain_fwd_ms:.3f} ms); K3p "
        f"{times['K3p']:.3f} ms, K4s {times['K4s']:.3f} ms; K3p max abs err "
        f"{fwd_err:.3g}; weight seeds {[0] + list(seeds)} within the bars "
        f"[{card}]", flush=True)
  _redesign_report(card, "K4s", label, times["K4s"], bounds["K4s"])
  print(f"{label}: K4s gradient closest to its bar (kernel, bf16 twin, "
        f"bar): {worst} {[round(x, 4) for x in errs[worst]]}; largest "
        f"relative difference from K4a+K4b per tensor: "
        f"{ {n: float(f'{e:.3g}') for n, e in vs_split.items()} }",
        flush=True)
  out = {}
  for key in ("K3p", "K4s"):
    out[key] = dict(name=WRAPPERS[key], route="cuda",
                    source=TRAIN_SOURCES[key], replaces=REPLACES[key],
                    ms=times[key], bound_ms=bounds[key][0],
                    bound_by=bounds[key][1], library_ms=None, rays=r,
                    samples=s_, views=v)
  out["K3p"].update(max_abs_err=fwd_err, plain_ms=plain_fwd_ms)
  out["K4s"].update(max_abs_err=abs_err,
                    worst_grad=[worst] + list(errs[worst]),
                    max_rel_vs_split=max(vs_split.values()),
                    plain_ms=plain_fb_ms - plain_fwd_ms)
  return out


def _group_grads(model, loss_fn):
  """The loss and every group's flattened gradient after one backward."""
  model.zero_grad(set_to_none=True)
  loss = loss_fn()
  loss.backward()
  grads = {k: torch.cat([p.grad.reshape(-1) for p in ps])
           for k, ps in model.param_groups().items()}
  model.zero_grad(set_to_none=True)
  return float(loss.detach()), grads


def _rel(got, want):
  """Loss and per-group gradient relative differences; NaN fails."""
  loss_rel = abs(got[0] - want[0]) / abs(want[0])
  group = {k: float((g - want[1][k]).norm() / want[1][k].norm())
           for k, g in got[1].items()}
  ok = loss_rel <= 1e-2 and all(v <= 5e-2 for v in group.values())
  return loss_rel, group, ok


def _mono_phases(card, dev, h, w, n_rand, t_cfg):
  """Phase 6: the mono model at bench.py's width.  Returns the training
  kernels' results at the mono step's shapes (K2r/K5a/K5b and K5c/K5d at
  V = 14, K3r/K4a/K4b at V = 9) and the launches of one step per route."""
  from dynibar_tpu_torch.config import mono_render_settings
  from dynibar_tpu_torch.data.ray_batch import synthetic_mono_batch
  from dynibar_tpu_torch.models.dynibar import MonoModel
  from dynibar_tpu_torch.ops import agg
  from dynibar_tpu_torch.render import render_rays as rr
  from dynibar_tpu_torch.train import losses, trainer
  from dynibar_tpu_torch.utils import kernel_check as kc
  from dynibar_tpu_torch.utils.device import to_device
  # bench.py:257-262: N_rand 3072, 64 samples, num_source_views 7, num_vv
  # 3, 6 bases, bf16, 48 frames
  cfg = mono_render_settings(num_source_views=7, num_vv=3, n_samples=64,
                             num_basis=6, compute_dtype="bfloat16")
  model = MonoModel(cfg, num_frames=48, seed=SEED)

  # ---- 6a: the kernels at the mono step's shapes ----
  rb = to_device(synthetic_mono_batch(cfg, n_rays=n_rand, h=h, w=w,
                                      num_frames=48, seed=SEED + 1), dev)
  with torch.no_grad():
    fm = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"],
                               rb["anchor_src_rgbs"])
    pts, _, _ = rr.sampling.sample_along_ray(
        rb["ray_o"], rb["ray_d"], rb["depth_range"], cfg.n_samples,
        cfg.inv_uniform, det=True)
    ins = rr.stage_inputs(model, rb, fm, cfg, None, pts, kernels=False)
    # the anchor pass's dynamic inputs: the anchor views at the anchor time
    rb_a = dict(rb, src_rgbs=rb["anchor_src_rgbs"],
                src_cameras=rb["anchor_src_cameras"],
                src_offset_idx=rb["anchor_offset_idx"],
                src_valid=rb["anchor_valid"], ref_time=rb["anchor_time"],
                ref_frame_idx=rb["anchor_frame_idx"])
    dy10 = rr.stage_inputs(model, rb_a, (fm[1], None, fm[2]), cfg, None,
                           pts, kernels=False)["dy"]
    st, dy9 = ins["st"], ins["dy"]
    got = agg.fused_static_aggregator(model.net_coarse_st, *st)
    errs = []
    for i in range(0, n_rand, kc.TWIN_RAYS):
      part = [a[i:i + kc.TWIN_RAYS] for a in st]
      errs.append(_compare_raw("K2 (mono V=14)", got[i:i + kc.TWIN_RAYS],
                               model.net_coarse_st(*part), 2e-2, 2e-2))
    print(f"K2 at the mono step's shapes ({n_rand} rays, S=64, V=14): max "
          f"abs err {max(errs):.3g} [{card}]", flush=True)
    for dy in (dy9, dy10):
      v = dy[1].shape[2]
      got = agg.fused_dynamic_aggregator(model.net_coarse_dy, *dy)
      errs = [_compare_raw(f"K3 (mono V={v})", got[i:i + kc.TWIN_RAYS],
                           model.net_coarse_dy(
                               *[a[i:i + kc.TWIN_RAYS] for a in dy]),
                           1e-2, 2e-2)
              for i in range(0, n_rand, kc.TWIN_RAYS)]
      print(f"K3 at the mono step's shapes ({n_rand} rays, S=64, V={v}): "
            f"max abs err {max(errs):.3g} [{card}]", flush=True)
  fwd_shapes = {"K2": {}, "K3": {}}
  for static, net, args in ((True, model.net_coarse_st, st),
                            (False, model.net_coarse_dy, dy9),
                            (False, model.net_coarse_dy, dy10)):
    r, s, v = args[3 if static else 1].shape[:3]
    label = f"mono step R={r} S={s} V={v}"
    fwd_shapes["K2" if static else "K3"][label] = _forward_report(
        card, label, static, net, args)
  del rb, rb_a, fm, ins, got
  g_cot = torch.Generator(device=dev).manual_seed(SEED + 2)
  results = {}
  for label, static, net, args, bwd in (
      ("mono static V=14", True, model.net_coarse_st, st, "pallas_split"),
      ("mono static V=14 split3", True, model.net_coarse_st, st,
       "pallas_split3"),
      ("mono dynamic V=9", False, model.net_coarse_dy, dy9, "pallas_split"),
      ("mono dynamic V=10", False, model.net_coarse_dy, dy10,
       "pallas_split")):
    cot = torch.randn(*args[0].shape[:2], 4, generator=g_cot, device=dev)
    res = _check_training_kernels(card, label, static, net, args, cot, bwd)
    if label != "mono dynamic V=10":
      results.update(res)
    if not static:
      # 6a': the "pallas" route at the same shape, four weight seeds
      res = _check_single_kernels(card, label, net, args, cot,
                                  seeds=WEIGHT_SEEDS[1:])
      if label == "mono dynamic V=9":
        results.update(res)
      else:
        results["K4s V=10"] = res["K4s"]
  del st, dy9, dy10, args, res
  torch.cuda.empty_cache()

  # ---- 6b: one 1024-ray eval chunk ----
  chunk = 1024
  rb = to_device(synthetic_mono_batch(cfg, n_rays=chunk, h=h, w=w,
                                      num_frames=48, seed=SEED,
                                      scanline=True), dev)
  with torch.no_grad():
    fm = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
  _zero_counts()
  ret = rr.render_rays_mono(model, rb, fm, cfg)
  torch.cuda.synchronize()
  launches = _read_counts()
  if launches != dict({k: 0 for k in launches}, K1=2, K2=1, K3=1):
    raise AssertionError(f"mono chunk launches {launches}, want K1 2, K2 1, "
                         "K3 1")
  plain = rr.render_rays_mono(model, rb, fm, cfg, kernels=False)
  rgb = ret["outputs_coarse_ref"]["rgb"]
  if not torch.isfinite(rgb).all() or rgb.shape != (chunk, 3):
    raise AssertionError("mono chunk: rgb not finite or misshapen")
  err = float((rgb - plain["outputs_coarse_ref"]["rgb"]).abs().max())
  if err > 3e-2:
    raise AssertionError(f"mono chunk: kernel vs plain rgb {err}")
  chunk_ms = _time_ms(lambda: rr.render_rays_mono(model, rb, fm, cfg),
                      iters=5)
  print(f"mono chunk launches: { {k: launches[k] for k in ('K1', 'K2', 'K3')} }"
        f"; {chunk_ms:.2f} ms/chunk = {chunk * 1e3 / chunk_ms:.1f} rays/s, "
        f"rgb kernel vs plain max abs {err:.3g} [{card}]", flush=True)
  del model, rb, fm, ret, plain
  torch.cuda.empty_cache()

  # ---- 6c: the mono train step on each backward route ----
  weights = losses.schedule_weights(t_cfg, 2)
  batch = to_device(synthetic_mono_batch(cfg, n_rays=n_rand, h=h, w=w,
                                         num_frames=48, seed=SEED), dev)
  step_launches, step_stats = {}, {}
  for route, (st_bwd, dy_bwd) in MONO_ROUTES.items():
    rcfg = dataclasses.replace(cfg, fused_st_bwd_impl=st_bwd,
                               fused_bwd_impl=dy_bwd)
    model = MonoModel(rcfg, num_frames=48, seed=SEED).train_all()
    opt = trainer.make_mono_optimizer(model, t_cfg)

    def step(seed, bootstrap=False):
      gen = torch.Generator(dev).manual_seed(seed)
      return trainer.mono_train_step(model, opt, batch, weights, rcfg, t_cfg,
                                     bootstrap=bootstrap, generator=gen)

    def loss_fn(kernels=True, other=None):
      gen = torch.Generator(dev).manual_seed(SEED + 1)
      model.cfg = rcfg if other is None else dataclasses.replace(
          rcfg, fused_st_bwd_impl=MONO_ROUTES[other][0],
          fused_bwd_impl=MONO_ROUTES[other][1])
      try:
        with contextlib.ExitStack() as stack:
          if not kernels:
            stack.enter_context(kc.sliced_twin(model.net_coarse_st))
            stack.enter_context(kc.sliced_twin(model.net_coarse_dy))
          return trainer.mono_loss(model, batch, weights, rcfg,
                                   kernels=kernels, generator=gen)[0]
      finally:
        model.cfg = rcfg

    _zero_counts()
    t0 = time.perf_counter()
    loss, metrics, _ = step(SEED)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    step_launches[route] = _read_counts()
    if step_launches[route] != MONO_LAUNCHES[route]:
      raise AssertionError(f"mono step ({route}) launches "
                           f"{step_launches[route]}, want "
                           f"{MONO_LAUNCHES[route]}")
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
      raise AssertionError(f"mono step ({route}): non-finite metrics")
    print(f"mono step ({route}) launches: {step_launches[route]}; first step "
          f"{first_s:.2f} s, loss {float(loss):.5f}, psnr "
          f"{float(metrics['psnr']):.3f}, grad_norm "
          f"{float(metrics['grad_norm']):.4g}", flush=True)

    # kernel vs plain gradients after one update, from the same weights and
    # sample placement (the plain aggregators in checkpointed 512-ray
    # slices); on the second route also the first route's kernels
    ker = _group_grads(model, loss_fn)
    loss_rel, group, ok = _rel(ker, _group_grads(
        model, lambda: loss_fn(kernels=False)))
    print(f"mono step ({route}) kernel vs plain (N_rand {n_rand}): loss rel "
          f"{loss_rel:.2e}; gradient rel-norm per group "
          f"{({k: round(v, 5) for k, v in group.items()})}", flush=True)
    if not ok:
      raise AssertionError(f"mono step ({route}): kernel and plain "
                           "gradients disagree")
    if route != "pallas_split":
      loss_rel, group, ok = _rel(ker, _group_grads(
          model, lambda: loss_fn(other="pallas_split")))
      print(f"mono step: {route} vs pallas_split kernels, same "
            f"weights: loss rel {loss_rel:.2e}; gradient rel-norm per group "
            f"{({k: round(v, 6) for k, v in group.items()})}", flush=True)
      if not ok:
        raise AssertionError(f"mono step: routes {route} and pallas_split "
                             "disagree")
    del ker
    torch.cuda.empty_cache()

    for i in range(2):                                    # warm-up
      step(SEED + 10 + i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    secs = []
    for i in range(5):
      t0 = time.perf_counter()
      step(SEED + 20 + i)
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_stats[route] = dict(s_per_step=float(np.mean(secs)),
                             peak_gib=peak_gib)
    print(f"mono train step ({route}): {np.mean(secs):.4f} s/step at N_rand "
          f"{n_rand}, mean of {len(secs)} after 2 warm-ups (min "
          f"{min(secs):.4f}, max {max(secs):.4f}), peak memory "
          f"{peak_gib:.2f} GiB ({held_gib:.2f} GiB held before the steps) "
          f"[{card}]", flush=True)
    curve = [float(step(SEED + 30)[0]) for _ in range(10)]
    print(f"mono train loss over 10 steps on one batch ({route}): "
          f"{[round(x, 5) for x in curve]}", flush=True)
    if not (np.isfinite(curve).all() and curve[-1] < curve[0]):
      raise AssertionError(f"mono step ({route}): the loss did not fall")
    _zero_counts()
    loss, metrics, _ = step(SEED + 40, bootstrap=True)
    torch.cuda.synchronize()
    boot = {k: n for k, n in _read_counts().items() if n}
    if not (bool(torch.isfinite(loss)) and boot.get("K2r") == 1
            and boot.get("K5a") == 1):
      raise AssertionError(f"mono bootstrap step ({route}): loss "
                           f"{float(loss)}, launches {boot}")
    print(f"mono bootstrap step ({route}): loss {float(loss):.5f}, "
          f"launches {boot}", flush=True)
    del model, opt, step, loss_fn, loss, metrics
    torch.cuda.empty_cache()
  return results, step_launches, step_stats, fwd_shapes


def _add_coarse(res, key, coarse_results, coarse_launches, chain):
  """A training kernel's figures at the FF coarse step's shapes: ms and
  bound (V = 7 for the dynamic ones), launches of one coarse step per
  route and in the chain's fine-stage CLI run."""
  mine = coarse_results[key]
  res.update(coarse_ms=mine["ms"], coarse_bound_ms=mine["bound_ms"],
             coarse_max_abs_err=mine["max_abs_err"],
             coarse_launches={route: n[key]
                              for route, n in coarse_launches.items()},
             chain_cli_launches=chain["cli_launches"][key])
  if key + " V=6" in coarse_results:
    res["coarse_ms_v6"] = coarse_results[key + " V=6"]["ms"]
  if key + " mask_rgb0" in coarse_results:
    res["coarse_mask_rgb0_max_abs_err"] = (
        coarse_results[key + " mask_rgb0"]["max_abs_err"])


def _coarse_kernels(card, dev, h, w, n_rand, cfg, model):
  """Phase 11a: the training kernels at the FF coarse step's shapes (S =
  64; static V = 11, dynamic V = 7 and the anchor pass's 6) on every
  backward route, as in 2b; the static ones also at mask_rgb = 0 (the
  Nvidia configs' setting, which cli/train_ff trains at).  Returns
  {kernel id (" V=6" appended for the anchor shape, " mask_rgb0" for
  that case): result dict}."""
  from dynibar_tpu_torch.data.ray_batch import synthetic_ff_batch
  from dynibar_tpu_torch.render import render_rays as rr
  from dynibar_tpu_torch.utils.device import to_device
  rb = to_device(synthetic_ff_batch(cfg, n_rays=n_rand, h=h, w=w,
                                    num_frames=48, seed=SEED + 1), dev)
  with torch.no_grad():
    fm = model.encode_coarse_featmaps(rb["src_rgbs"], rb["static_src_rgbs"],
                                      rb["anchor_src_rgbs"])
    pts, _, _ = rr.sampling.sample_along_ray(
        rb["ray_o"], rb["ray_d"], rb["depth_range"], cfg.n_samples,
        cfg.inv_uniform, det=True)
    ins = rr.stage_inputs(model, rb, fm, cfg, "coarse", pts, kernels=False)
    # the anchor pass's dynamic inputs: the anchor views at the anchor time
    rb_a = dict(rb, src_rgbs=rb["anchor_src_rgbs"],
                src_cameras=rb["anchor_src_cameras"],
                src_offset_idx=rb["anchor_offset_idx"],
                src_valid=rb["anchor_valid"], ref_time=rb["anchor_time"],
                ref_frame_idx=rb["anchor_frame_idx"])
    dy6 = rr.stage_inputs(model, rb_a, (fm[1], None, fm[2]), cfg, "coarse",
                          pts, kernels=False)["dy"]
  st, dy7 = ins["st"], ins["dy"]
  del rb, rb_a, fm, ins
  st_rgb0 = copy.deepcopy(model.net_coarse_st)
  st_rgb0.mask_rgb = False
  g_cot = torch.Generator(device=dev).manual_seed(SEED + 3)
  results = {}
  for label, suffix, static, net, args, bwd in (
      ("FF coarse static V=11", "", True, model.net_coarse_st, st,
       "pallas_split"),
      ("FF coarse static V=11 split3", "", True, model.net_coarse_st, st,
       "pallas_split3"),
      ("FF coarse static V=11 mask_rgb=0", " mask_rgb0", True, st_rgb0, st,
       "pallas_split"),
      ("FF coarse dynamic V=7", "", False, model.net_coarse_dy, dy7,
       "pallas_split"),
      ("FF coarse dynamic V=6", " V=6", False, model.net_coarse_dy, dy6,
       "pallas_split")):
    cot = torch.randn(*args[0].shape[:2], 4, generator=g_cot, device=dev)
    res = _check_training_kernels(card, label, static, net, args, cot, bwd)
    if not static:                  # the same shape on the "pallas" route
      res.update(_check_single_kernels(card, label, net, args, cot))
    for key, r in res.items():
      results.setdefault(key + suffix, r)
  del st, dy7, dy6, args, res, st_rgb0
  torch.cuda.empty_cache()
  return results


def _coarse_step(card, dev, h, w, n_rand, cfg, t_cfg):
  """Phase 11b: ff_coarse_train_step at N_rand on each backward route:
  the launches of one step, kernel vs plain loss and per-group gradients
  (plain coarse aggregators in checkpointed 512-ray slices), s/step and
  peak memory, 10 steps on one batch with a falling loss, and the fine
  groups bit-identical throughout.  Returns (launches, stats) per
  route."""
  from dynibar_tpu_torch.data.ray_batch import synthetic_ff_batch
  from dynibar_tpu_torch.models.dynibar import FF_FINE_KEYS, FFModel
  from dynibar_tpu_torch.train import losses, trainer
  from dynibar_tpu_torch.utils import kernel_check as kc
  from dynibar_tpu_torch.utils.device import to_device
  weights = losses.schedule_weights(t_cfg, 0)
  batch = to_device(synthetic_ff_batch(cfg, n_rays=n_rand, h=h, w=w,
                                       num_frames=48, seed=SEED), dev)
  step_launches, step_stats = {}, {}
  for route, (st_bwd, dy_bwd) in MONO_ROUTES.items():
    rcfg = dataclasses.replace(cfg, fused_st_bwd_impl=st_bwd,
                               fused_bwd_impl=dy_bwd)
    model = FFModel(rcfg, num_frames=48, seed=SEED).train_coarse()
    opt = trainer.make_ff_coarse_optimizer(model, t_cfg)
    fine0 = {k: v.clone() for k, v in model.state_dict().items()
             if k.split(".")[0] in FF_FINE_KEYS}

    def step(seed):
      gen = torch.Generator(dev).manual_seed(seed)
      return trainer.ff_coarse_train_step(model, opt, batch, weights, rcfg,
                                          t_cfg, generator=gen)

    def loss_fn(kernels=True):
      gen = torch.Generator(dev).manual_seed(SEED + 1)
      with contextlib.ExitStack() as stack:
        if not kernels:
          stack.enter_context(kc.sliced_twin(model.net_coarse_st))
          stack.enter_context(kc.sliced_twin(model.net_coarse_dy))
        return trainer.ff_coarse_loss(model, batch, weights, rcfg,
                                      kernels=kernels, generator=gen)[0]

    _zero_counts()
    t0 = time.perf_counter()
    loss, metrics, _ = step(SEED)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    step_launches[route] = _read_counts()
    if step_launches[route] != COARSE_LAUNCHES[route]:
      raise AssertionError(f"FF coarse step ({route}) launches "
                           f"{step_launches[route]}, want "
                           f"{COARSE_LAUNCHES[route]}")
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
      raise AssertionError(f"FF coarse step ({route}): non-finite metrics")
    print(f"FF coarse step ({route}) launches: {step_launches[route]}; "
          f"first step {first_s:.2f} s, loss {float(loss):.5f}, psnr "
          f"{float(metrics['psnr']):.3f}, grad_norm "
          f"{float(metrics['grad_norm']):.4g}", flush=True)
    # kernel vs plain gradients after one update (the motion coefficients,
    # zero at init, then pass a gradient to the basis)
    loss_rel, group, ok = _rel(_group_grads(model, loss_fn), _group_grads(
        model, lambda: loss_fn(kernels=False)))
    print(f"FF coarse step ({route}) kernel vs plain (N_rand {n_rand}): "
          f"loss rel {loss_rel:.2e}; gradient rel-norm per group "
          f"{({k: round(v, 5) for k, v in group.items()})}", flush=True)
    if not ok:
      raise AssertionError(f"FF coarse step ({route}): kernel and plain "
                           "gradients disagree")
    torch.cuda.empty_cache()
    for i in range(2):                                    # warm-up
      step(SEED + 10 + i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    secs = []
    for i in range(5):
      t0 = time.perf_counter()
      step(SEED + 20 + i)
      torch.cuda.synchronize()
      secs.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_stats[route] = dict(s_per_step=float(np.mean(secs)),
                             min=min(secs), max=max(secs), peak_gib=peak_gib)
    print(f"FF coarse train step ({route}): {np.mean(secs):.4f} s/step at "
          f"N_rand {n_rand}, mean of {len(secs)} after 2 warm-ups (min "
          f"{min(secs):.4f}, max {max(secs):.4f}), peak memory "
          f"{peak_gib:.2f} GiB ({held_gib:.2f} GiB held before the steps) "
          f"[{card}]", flush=True)
    curve = [float(step(SEED + 30)[0]) for _ in range(10)]
    print(f"FF coarse train loss over 10 steps on one batch ({route}): "
          f"{[round(x, 5) for x in curve]}", flush=True)
    if not (np.isfinite(curve).all() and curve[-1] < curve[0]):
      raise AssertionError(f"FF coarse step ({route}): the loss did not "
                           "fall")
    moved = [k for k, v in model.state_dict().items() if k in fine0
             and not torch.equal(v, fine0[k])]
    if moved:
      raise AssertionError(f"FF coarse step ({route}): fine groups moved: "
                           f"{moved[:5]}")
    del model, opt, step, loss_fn, loss, metrics
    torch.cuda.empty_cache()
  print("FF coarse step: the fine groups bit-identical over each route's "
        "18 steps", flush=True)
  return step_launches, step_stats


def _coarse_chain(card, dev, h, w, n_rand, frames=24, coarse_steps=48):
  """Phase 11c: the FF training chain from disk at the Nvidia config
  (configs_nvidia/eval_balloon1_long.txt: 64 + 64 samples, bf16,
  mask_rgb = 0, mask_static): ConsistentScene.write_nvidia, coarse_steps
  ff_coarse_train_step steps from a PrefetchPipeline over NvidiaSceneData
  and a port snapshot, then cli/train_ff.main on that folder for one epoch
  (n_iters frames - 1); the CLI's coarse groups equal the coarse run's
  bit for bit, the loss falls in each stage; the two held-out views'
  crop-3% PSNR before and after the fine stage, printed.  Returns the
  CLI's launches."""
  import tempfile
  from dynibar_tpu_torch.cli import train_ff
  from dynibar_tpu_torch.config import INIT_SEED, STEP_SEED, DynibarConfig
  from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
  from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
  from dynibar_tpu_torch.data.synthetic_scene import ConsistentScene
  from dynibar_tpu_torch.eval.held_out import eval_ff, held_out_views
  from dynibar_tpu_torch.models.dynibar import FF_COARSE_KEYS, FFModel
  from dynibar_tpu_torch.train import losses, trainer
  from dynibar_tpu_torch.utils import checkpoints as ckpt
  config_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs_nvidia", "eval_balloon1_long.txt")
  name = "consistent_nvidia"
  with tempfile.TemporaryDirectory() as root:
    t0 = time.perf_counter()
    scene = ConsistentScene(num_frames=frames, height=h, width=w)
    scene.write_nvidia(root, name)
    print(f"chain: wrote a {frames}-frame {h}x{w} ConsistentScene in the "
          f"Nvidia layout in {time.perf_counter() - t0:.1f} s", flush=True)
    config = DynibarConfig.from_file(
        config_file, folder_path=root, rootdir=root, eval_scenes=[name],
        N_rand=n_rand, workers=4, chunk_size=4096, training_height=h)
    cfg = config.render_settings("ff_train")
    data = NvidiaSceneData(config, name, cfg=cfg, height=h)
    config.num_frames = data.num_frames
    t_cfg = config.train_settings()
    views = held_out_views(scene, data)

    # ---- the coarse stage ----
    model = FFModel(cfg, frames, device=dev, seed=INIT_SEED).train_coarse()
    opt = trainer.make_ff_coarse_optimizer(model, t_cfg)
    gen = torch.Generator(dev).manual_seed(STEP_SEED)
    curve = []
    _zero_counts()
    with PrefetchPipeline(lambda r, _: data.sample_batch(r, n_rand),
                          num_workers=config.workers, seed=0,
                          device=dev) as pipe:
      t0 = time.perf_counter()
      for i in range(coarse_steps):
        epoch = i // frames
        data.set_epoch(epoch)
        loss, _, _ = trainer.ff_coarse_train_step(
            model, opt, next(pipe), losses.schedule_weights(t_cfg, epoch),
            cfg, t_cfg, generator=gen)
        curve.append(loss)
      curve = [float(x) for x in curve]          # one sync, at the end
      coarse_s = (time.perf_counter() - t0) / coarse_steps
      coarse_wait = pipe.wait_s
    coarse_launches = {k: n for k, n in _read_counts().items() if n}
    coarse_dir = os.path.join(root, "coarse_run")
    ckpt.save_checkpoint(coarse_dir, coarse_steps, model.state_dict(),
                         opt.state_dict())
    coarse_sd = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()
                 if k.split(".")[0] in FF_COARSE_KEYS}
    first, last = np.mean(curve[:12]), np.mean(curve[-12:])
    print(f"chain coarse: {coarse_steps} steps, {coarse_s:.4f} s/step, "
          f"{coarse_wait:.2f} s getting batches from the pipeline; loss "
          f"mean of the first 12 {first:.5f}, of the last 12 {last:.5f}; "
          f"launches {coarse_launches} [{card}]", flush=True)
    if not (np.isfinite(curve).all() and last < first):
      raise AssertionError(f"chain coarse: the loss did not fall {curve}")
    del model, opt
    torch.cuda.empty_cache()

    # held-out views, fine render before the fine stage: the CLI's initial
    # model (the same seed and graft)
    model, _ = trainer.create_ff_train_state(cfg, t_cfg, frames, device=dev,
                                             seed=INIT_SEED, coarse=coarse_sd)
    t0 = time.perf_counter()
    before = eval_ff(model, data, cfg, config.chunk_size, views)
    eval_s = (time.perf_counter() - t0) / len(views)
    del model
    torch.cuda.empty_cache()

    # ---- the fine stage through the CLI ----
    args = ["--config", config_file, "--folder_path", root, "--rootdir",
            root, "--eval_scenes", name, "--coarse_dir", coarse_dir,
            "--training_height", str(h), "--N_rand", str(n_rand), "--n_iters", str(frames - 1),
            "--i_print", "1", "--i_weights", str(frames), "--workers", "4",
            "--expname", "chain"]
    _zero_counts()
    log = io.StringIO()                 # the CLI's per-step lines
    with contextlib.redirect_stdout(log):
      out = train_ff.main(args)["out_folder"]
    torch.cuda.synchronize()
    cli_launches = _read_counts()
    snap = ckpt.load_checkpoint(ckpt.latest_checkpoint(out),
                                map_location="cpu")
    same = all(torch.equal(snap["model"][k], v) for k, v in coarse_sd.items())
    logs = os.path.join(root, "logs", "fine_chain")
    with open(os.path.join(logs, "metrics.jsonl")) as fh:
      recs = [json.loads(line) for line in fh]
    fine_curve = [r["train_fine/loss"] for r in recs
                  if "train_fine/loss" in r]
    rec = _cli_phases(logs)[-1][1]
    f_first, f_last = np.mean(fine_curve[:6]), np.mean(fine_curve[-6:])
    print(f"chain cli: {rec['steps']:.0f} steps, "
          f"{rec['seconds'] / rec['steps']:.4f} s/step, {rec['wait_s']:.2f} s "
          f"getting batches from the pipeline; loss mean of the first 6 "
          f"{f_first:.5f}, of the last 6 {f_last:.5f}; coarse groups equal "
          f"to the coarse run's: {same}; launches "
          f"{ {k: n for k, n in cli_launches.items() if n} } [{card}]",
          flush=True)
    if not (same and snap["step"] == frames and len(fine_curve) == frames
            and np.isfinite(fine_curve).all() and f_last < f_first
            and all(cli_launches[k] > 0 for k in ("K1", "K2", "K3", "K2r",
                                                  "K5a", "K5b", "K3r",
                                                  "K4a", "K4b"))):
      raise AssertionError(f"chain cli: step {snap['step']}, coarse equal "
                           f"{same}, losses {fine_curve}, launches "
                           f"{cli_launches}")
    model = FFModel(cfg, frames, device=dev)
    model.load_state_dict(snap["model"])
    after = eval_ff(model, data, cfg, config.chunk_size, views)
    del model
    torch.cuda.empty_cache()
  for key in sorted(k for k in before if k.endswith("_crop3")):
    print(f"chain held-out {key}: {before[key]:.3f} dB before the fine "
          f"stage, {after[key]:.3f} after", flush=True)
  print(f"chain: {eval_s:.2f} s per held-out {h}x{w} view (both stages, "
        f"chunk {config.chunk_size}) [{card}]", flush=True)
  return dict(cli_launches=cli_launches,
              cli_s_per_step=rec["seconds"] / rec["steps"],
              cli_wait_s=rec["wait_s"], coarse_s_per_step=coarse_s)


def _cli_phases(logs):
  """The CLI's phase records in its metrics log, in order: (name, record
  with the "phase/<name>/" prefix taken off)."""
  with open(os.path.join(logs, "metrics.jsonl")) as fh:
    recs = [json.loads(line) for line in fh]
  out = []
  for r in recs:
    for name in sorted({k.split("/")[1] for k in r if k.startswith("phase/")}):
      pre = f"phase/{name}/"
      out.append((name, {k[len(pre):]: v for k, v in r.items()
                         if k.startswith(pre)}))
  return out


def _cli_phase(card, dev, h, w, root, frames=48, n_rand=3072, chunk=4096):
  """Phase 8: the training CLI from an on-disk scene written under `root`,
  twice (the second run resumes), and the CLI's panel function on a batch
  of the scene against a plain-path render of the same view.  Returns the
  launches of the first run and the last snapshot's path."""
  from dynibar_tpu_torch.cli import train as cli_train
  from dynibar_tpu_torch.data.factory import create_training_dataset
  from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
  from dynibar_tpu_torch.data.synthetic_scene import write_synthetic_scene
  from dynibar_tpu_torch.models.dynibar import MonoModel
  from dynibar_tpu_torch.render import render_rays as rr
  from dynibar_tpu_torch.render.render_image import full_image_ray_batch
  from dynibar_tpu_torch.train.view_logging import log_train_view
  from dynibar_tpu_torch.utils import checkpoints as ckpt
  from dynibar_tpu_torch.utils.device import to_device
  from dynibar_tpu_torch.utils.logging import MetricsLogger
  t0 = time.perf_counter()
  write_synthetic_scene(root, "scene", num_frames=frames, height=h, width=w)
  print(f"cli: wrote a {frames}-frame {h}x{w} scene in "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  # bench.py's mono shape on the "pallas" route; init_decay_epoch 2: one
  # bootstrap epoch, then n_iters 48 (counted from the start step, as
  # the JAX CLI counts it) runs one phase-2 epoch; the panel renders
  # at the last step; a checkpoint also a third into phase 2
  mid = frames + frames // 3
  args = ["--folder_path", root, "--train_scenes", "scene", "--rootdir",
          root, "--training_height", str(h), "--N_rand", str(n_rand),
          "--N_samples", "64", "--num_source_views", "7", "--num_vv", "3",
          "--num_basis", "6", "--fused_bwd_impl", "pallas",
          "--init_decay_epoch", "2", "--compute_dtype", "bfloat16",
          "--i_img", str(2 * frames), "--i_weights", str(mid),
          "--i_print", "24", "--workers", "4", "--chunk_size", str(chunk)]
  # the pipeline's wait per step, from each __next__ of the first run
  waits, plain_next = [], PrefetchPipeline.__next__

  def timed_next(pipe):
    before = pipe.wait_s
    item = plain_next(pipe)
    waits.append(pipe.wait_s - before)
    return item

  PrefetchPipeline.__next__ = timed_next
  _zero_counts()
  try:
    first = cli_train.main(args + ["--n_iters", str(frames)])
  finally:
    PrefetchPipeline.__next__ = plain_next
  torch.cuda.synchronize()
  launches = _read_counts()
  out = first["out_folder"]
  logs = os.path.join(root, "logs", os.path.basename(out))
  snaps = sorted(p for p in os.listdir(out) if p.startswith("model_"))
  phases = _cli_phases(logs)
  panels = [p for p in os.listdir(os.path.join(logs, "images"))
            if p.startswith(f"{2 * frames:08d}_train_")]
  if not (first["start_step"] == 0
          and [(n, r["steps"]) for n, r in phases] == [("bootstrap", frames),
                                                       ("train", frames)]
          and snaps == [f"model_{mid:08d}.pt",
                        f"model_{2 * frames:08d}.pt"]
          and phases[1][1]["panels"] == 1 and len(panels) == 22
          and all(launches[k] > 0 for k in ("K1", "K2", "K3", "K2r", "K5a",
                                            "K5b", "K3p", "K4s"))):
    raise AssertionError(f"cli: phases {phases}, snapshots {snaps}, "
                         f"{len(panels)} panels, launches {launches}")
  print(f"cli pipeline wait per step: {np.mean(waits[:10]):.4f} s over "
        f"the first 10 steps, {np.mean(waits[10:]):.4f} s over the next "
        f"{len(waits) - 10} (frames decoded by the C++ host decoder; "
        f"{len(os.sched_getaffinity(0))} cores) [{card}]", flush=True)
  for name, rec in phases:
    print(f"cli {name}: {rec['seconds'] / rec['steps']:.4f} s/step over "
          f"{rec['steps']:.0f} steps, {rec['wait_s']:.2f} s getting "
          f"batches from the data pipeline [{card}]", flush=True)
  print(f"cli panel: {phases[1][1]['panel_s']:.3f} s/frame at {h}x{w} "
        f"(train view, anchor branch, 22 PNG panels); launches of the run "
        f"{launches} [{card}]", flush=True)

  # the CLI's panel function vs the plain path: the last checkpoint's
  # weights, a batch of the scene built here, kernels=False chunk by chunk
  config = cli_train.parse_args(args)[0]
  data = create_training_dataset(config)
  cfg = config.render_settings("mono")
  payload = ckpt.load_checkpoint(os.path.join(out, snaps[-1]),
                                 map_location=dev)
  model = MonoModel(cfg, num_frames=frames, device=dev)
  model.load_state_dict(payload["model"])
  rb = to_device(data.sample_batch(np.random.RandomState(SEED), n_rand,
                                   config.sample_mode), dev)
  frame_idx = int(rb["ref_frame_idx"])
  provider = data.providers[0]
  panel = log_train_view(MetricsLogger(logs, enabled=False), 2 * frames,
                         model, rb, cfg, chunk,
                         provider._load_rgb(frame_idx),
                         provider._load_disp(frame_idx))["outputs_coarse_ref"]
  full = full_image_ray_batch(rb, rb["camera"], device=dev)
  with torch.no_grad():
    fm = model.encode_featmaps(full["src_rgbs"], full["static_src_rgbs"],
                               full["anchor_src_rgbs"])
    rgbs = []
    for i in range(0, h * w, chunk // 2):
      part = {k: (v[i:i + chunk // 2] if k in ("ray_o", "ray_d", "uv_grid")
                  else v) for k, v in full.items()}
      rgbs.append(rr.render_rays_mono(
          model, part, fm, cfg, is_train=True, kernels=False,
          device=dev)["outputs_coarse_ref"]["rgb"])
  plain = torch.cat(rgbs).cpu().numpy().reshape(h, w, 3)
  plain = plain * (panel["mask"][..., None] > 0)
  err = float(np.abs(panel["rgb"] - plain).max())
  if not (np.isfinite(panel["rgb"]).all() and err <= 3e-2):
    raise AssertionError(f"cli panel: kernel vs plain rgb {err}")
  print(f"cli panel rgb (frame {frame_idx}) vs the plain path: max abs "
        f"{err:.3g}", flush=True)
  del model, fm, rgbs, full, payload, panel, rb
  torch.cuda.empty_cache()

  # the second run: the parameters as the model loads them, recorded
  saved = ckpt.load_checkpoint(os.path.join(out, snaps[-1]),
                               map_location="cpu")["model"]
  loaded, load = {}, MonoModel.load_state_dict

  def recording_load(self, state, *a, **kw):
    res = load(self, state, *a, **kw)
    loaded.update({k: v.detach().cpu().clone()
                   for k, v in self.state_dict().items()})
    return res

  MonoModel.load_state_dict = recording_load
  try:
    second = cli_train.main(args + ["--n_iters", "1"])
  finally:
    MonoModel.load_state_dict = load
  same = bool(loaded) and all(torch.equal(loaded[k], v)
                              for k, v in saved.items())
  latest = ckpt.latest_checkpoint(out)
  (_, boot), (_, rec) = _cli_phases(logs)[2:]
  if not (second["start_step"] == 2 * frames and same
          and boot["steps"] == 0
          and latest.endswith(f"model_{3 * frames:08d}.pt")):
    raise AssertionError(f"cli resume: start {second['start_step']}, "
                         f"parameters equal {same}, bootstrap steps "
                         f"{boot['steps']}, latest {latest}")
  print(f"cli resume: at step {second['start_step']} with the saved "
        f"parameters, ran on to {3 * frames} "
        f"({rec['seconds'] / rec['steps']:.4f} s/step) [{card}]",
        flush=True)
  torch.cuda.empty_cache()
  return launches, latest


def _mask_rgb0_check(dev, nets, stage_args):
  """K2 with the rgb mask off (the Nvidia eval configs' mask_rgb = 0) vs
  its twin at the eval's coarse and fine shapes, on the stages' inputs as
  they are and with a quarter of the source pixels black (which the mask
  would drop, so the branch changes the output); the phase 2 bars."""
  from dynibar_tpu_torch.ops import agg
  errs = []
  g = torch.Generator(device=dev).manual_seed(SEED + 2)
  with torch.no_grad():
    for stage, net, args in zip(("coarse", "fine"), nets, stage_args):
      net0 = copy.deepcopy(net)
      net0.mask_rgb = False
      rgb_feat = args[3]
      keep = (torch.rand(rgb_feat.shape[:3] + (1,), generator=g,
                         device=dev) > 0.25).to(rgb_feat.dtype)
      black = torch.cat([rgb_feat[..., :3] * keep, rgb_feat[..., 3:]], -1)
      for label, feats in (("", rgb_feat), (", black pixels", black)):
        a = list(args)
        a[3] = feats.contiguous()
        want = net0(*a)
        errs.append(_compare_raw(f"K2 mask_rgb=0 {stage}{label}",
                                 agg.fused_static_aggregator(net0, *a), want,
                                 2e-2, 2e-2))
      if torch.allclose(net(*a), want):
        raise AssertionError(f"K2 mask_rgb=0 {stage}: the black pixels "
                             "did not change the twin's output")
      del net0, keep, black, a, want
  torch.cuda.synchronize()
  print(f"K2 at mask_rgb=0 (the eval configs) vs its twin: max abs err "
        f"coarse {max(errs[:2]):.3g}, fine {max(errs[2:]):.3g} (inputs as "
        f"they are / a quarter of the pixels black: "
        f"{[round(e, 5) for e in errs]})", flush=True)
  return max(errs)


def _viewpoint_times(text, frame):
  """The eval CLI's per-viewpoint seconds and its frame's seconds."""
  views = [(int(c), float(t)) for c, t in re.findall(
      rf"^frame {frame} cam (\d+): psnr=\S+ ssim=\S+ \(([\d.]+)s\)$",
      text, re.M)]
  whole = re.findall(rf"^frame {frame}: (\d+) viewpoints in ([\d.]+)s$",
                     text, re.M)
  return views, whole


class _Tee(io.StringIO):
  """Standard output kept as well as printed."""

  def write(self, text):
    sys.__stdout__.write(text)
    return super().write(text)


def _eval_phase(card, dev, h, w, frames=12, chunk=8192):
  """Phase 9: the Nvidia eval CLI (cli/eval_nvidia.main) on a scene the
  port writes, at the eval config's width; one viewpoint against the plain
  path.  Returns the launches per viewpoint frame."""
  import tempfile
  from dynibar_tpu_torch.cli import eval_nvidia as cli_eval
  from dynibar_tpu_torch.data.synthetic_scene import (
      write_synthetic_nvidia_scene)
  from dynibar_tpu_torch.eval import nvidia_eval
  from dynibar_tpu_torch.eval.metrics import masked_psnr
  config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs_nvidia", "eval_balloon1_long.txt")
  scene, frame = "Balloon1", 3
  with tempfile.TemporaryDirectory() as root:
    t0 = time.perf_counter()
    write_synthetic_nvidia_scene(root, scene, num_frames=frames, height=h,
                                 width=w)
    n_files = sum(len(f) for _, _, f in os.walk(root))
    print(f"eval: wrote a {frames}-frame {h}x{w} Nvidia scene ({n_files} "
          f"files, {frames * 12} of them JPEGs) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the CLI's renders timed (host clock; the render ends in a readback),
    # the first (viewpoint 0) kept to hold against the plain path below
    first, render_s, inner = {}, [], nvidia_eval.render_image_ff

    def recording(*a, **kw):
      t = time.perf_counter()
      out = inner(*a, **kw)
      render_s.append(time.perf_counter() - t)
      if not first:
        first.update(args=a, kw=kw, rgb=out["outputs_fine_ref"]["rgb"])
      return out

    args = ["--config", config, "--folder_path", root, "--rootdir", root,
            "--max_frames", "1"]
    log = _Tee()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nvidia_eval.render_image_ff = recording
    _zero_counts()
    try:
      t0 = time.perf_counter()
      with contextlib.redirect_stdout(log):
        results = cli_eval.main(args)
      torch.cuda.synchronize()
      cli_s = time.perf_counter() - t0
    finally:
      nvidia_eval.render_image_ff = inner
    launches = _read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    views, whole = _viewpoint_times(log.getvalue(), frame)
    n_chunks = -(-h * w // chunk)
    want = dict({k: 0 for k in launches}, K1=4 * n_chunks * len(views),
                K2=2 * n_chunks * len(views), K3=2 * n_chunks * len(views))
    table = results[scene]
    if not (len(views) == 11 and [c for c, _ in views] == [
        c for c in range(12) if c != frame % 12] and len(whole) == 1
            and int(whole[0][0]) == 11 and launches == want
            and all(np.isfinite(table[r][m]) for r in table
                    for m in ("psnr", "ssim"))
            and all(np.isnan(table[r]["lpips"]) for r in table)):
      raise AssertionError(f"eval: viewpoints {views}, frame {whole}, "
                           f"launches {launches} (want {want}), {table}")
    secs = [t for _, t in views]
    per_view = {k: launches[k] // len(views) for k in ("K1", "K2", "K3")}
    print(f"eval launches per viewpoint frame: {per_view} ({n_chunks} chunks "
          f"of {chunk} over {h * w} rays), {len(views)} viewpoints",
          flush=True)
    print(f"eval: {np.mean(secs):.3f} s per viewpoint frame at {h}x{w}, "
          f"chunk {chunk}, mean of {len(secs)} (min {min(secs):.3f}, max "
          f"{max(secs):.3f}; data, render, metrics); the frame of 11 "
          f"viewpoints {float(whole[0][1]):.3f} s (featmaps encoded once); "
          f"the CLI {cli_s:.1f} s; render_image_ff {np.mean(render_s):.3f} s "
          f"per viewpoint (min {min(render_s):.3f}, max {max(render_s):.3f}), "
          f"the rest {np.mean(secs) - np.mean(render_s):.3f} s (the batch's "
          f"18 source frames, ground truth, masks, metrics); peak memory "
          f"{peak_gib:.2f} GiB; psnr "
          f"full / dynamic / static {table['full']['psnr']:.3f} / "
          f"{table['dynamic']['psnr']:.3f} / {table['static']['psnr']:.3f} "
          f"[{card}]", flush=True)

    # viewpoint 0 through the plain twins, from the same inputs
    a, kw = first["args"], dict(first["kw"], kernels=False)
    plain = inner(*a[:5], 2048, *a[6:], **kw)["outputs_fine_ref"]["rgb"]
    kern = first["rgb"]
    err = float(np.abs(kern - plain).max())
    gt_path = os.path.join(root, scene, "dense", "mv_images",
                           f"{frame:05d}", "cam01.jpg")

    def psnr(pred):
      valid = np.tile(np.float32(pred.sum(-1, keepdims=True) > 1e-3),
                      (1, 1, 3))
      gt = nvidia_eval.imread_resized(gt_path, h, w) * valid
      return masked_psnr(gt, pred * valid, valid)

    if not (np.isfinite(kern).all() and kern.shape == (h, w, 3)
            and err <= 3e-2):
      raise AssertionError(f"eval: viewpoint 0 kernel vs plain rgb {err}")
    print(f"eval viewpoint 0 (frame {frame}) vs the plain path: rgb max abs "
          f"{err:.3g}; psnr against the ground truth kernel "
          f"{psnr(kern):.4f}, plain {psnr(plain):.4f}", flush=True)
    del first, plain, kern
  torch.cuda.empty_cache()
  return per_view


def _http(url, body=None):
  """(status, headers, bytes) of a GET, or of a POST of a JSON body."""
  import urllib.error
  import urllib.request
  data = None if body is None else json.dumps(body).encode()
  try:
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=600) as resp:
      return resp.status, resp.headers, resp.read()
  except urllib.error.HTTPError as e:
    return e.code, e.headers, e.read()


def _parts(body, boundary=b"--dynibar-frame"):
  """The payloads of a multipart/x-mixed-replace body."""
  out = []
  for chunk in body.split(boundary)[1:]:
    if chunk.startswith(b"--"):
      break
    head, _, rest = chunk.partition(b"\r\n\r\n")
    n = int([ln for ln in head.split(b"\r\n")
             if ln.lower().startswith(b"content-length")][0].split(b":")[1])
    out.append(rest[:n])
  return out


def _chunk_vs_plain(model, cfg, template, camera, dev, chunk, i, fm=None):
  """Chunk `i` of a frame (`chunk` rays) rendered through the kernels and
  through the plain twins from the same template and feature maps (`fm`,
  else encoded here); also K2 alone on that chunk's static inputs against
  its twin.  Returns (the kernel rgb * mask, the kernels' rgb error, K2's
  error)."""
  from dynibar_tpu_torch.ops import agg
  from dynibar_tpu_torch.render import render_rays as rr
  from dynibar_tpu_torch.render.render_image import full_image_ray_batch
  full = full_image_ray_batch(template, camera, device=dev)
  part = {k: (v[i * chunk:(i + 1) * chunk] if k in ("ray_o", "ray_d",
                                                    "uv_grid") else v)
          for k, v in full.items()}
  with torch.no_grad():
    if fm is None:
      fm = model.encode_featmaps(part["src_rgbs"], part["static_src_rgbs"])
    ker = rr.render_rays_mono(model, part, fm, cfg, device=dev)
    plain = rr.render_rays_mono(model, part, fm, cfg, device=dev,
                                kernels=False)
    rgb = ker["outputs_coarse_ref"]["rgb"]
    if not torch.isfinite(rgb).all() or rgb.shape != (chunk, 3):
      raise AssertionError("chunk: rgb not finite or misshapen")
    err = float((rgb - plain["outputs_coarse_ref"]["rgb"]).abs().max())
    pts, _, _ = rr.sampling.sample_along_ray(
        part["ray_o"], part["ray_d"], part["depth_range"], cfg.n_samples,
        cfg.inv_uniform, det=True)
    st = rr.stage_inputs(model, part, fm, cfg, None, pts,
                         kernels=False)["st"]
    k2 = _compare_raw("K2 (served chunk)",
                      agg.fused_static_aggregator(model.net_coarse_st, *st),
                      model.net_coarse_st(*st), 2e-2, 2e-2)
  mask = ker["outputs_coarse_ref"]["mask"].float()[:, None]
  return (rgb * mask).cpu().numpy(), err, k2


def _serve_phase(card, dev, h, w, cli_root, snapshot, chunk=8192,
                 cli_frames=12):
  """Phase 10: the served mono frame.  A SessionRegistry over phase 8's
  scene and checkpoint at configs/test_kid-running.txt's render settings
  behind make_server in a thread: /healthz, /meta, /render cold and warm
  at a frame's own pose (npy), at stride 4 with layers, /stream of a
  4-pose wander path; then the render CLI on a 12-frame scene with a
  seeded snapshot.  Returns the launches per full-frame request."""
  import tempfile
  import threading
  from dynibar_tpu_torch.cli import render_monocular as cli_render
  from dynibar_tpu_torch.cli.train import parse_args
  from dynibar_tpu_torch.core.cameras import make_camera
  from dynibar_tpu_torch.data import png
  from dynibar_tpu_torch.data.llff import parse_llff_pose
  from dynibar_tpu_torch.data.monocular import MonocularSceneData
  from dynibar_tpu_torch.data.synthetic_scene import write_synthetic_scene
  from dynibar_tpu_torch.models.dynibar import MonoModel
  from dynibar_tpu_torch.serve.registry import SessionRegistry
  from dynibar_tpu_torch.serve.server import make_server
  from dynibar_tpu_torch.utils import checkpoints as ckpt
  t_phase = time.perf_counter()
  kid = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                     "test_kid-running.txt")
  n_chunks = -(-h * w // chunk)
  per_frame = dict({k: 0 for k in _counters()}, K1=2 * n_chunks,
                   K2=n_chunks, K3=n_chunks)
  # the kid-running render settings (288x512, 64 samples, 7 source views,
  # 3 virtual views, mask_rgb 1, bf16, chunk 8192) over phase 8's scene
  # and last snapshot; phase 8 trained with anti-alias pooling, which the
  # snapshot's static model carries, so it serves with it
  config = parse_args(["--config", kid, "--folder_path", cli_root,
                       "--train_scenes", "scene", "--rootdir", cli_root,
                       "--ckpt_path", snapshot, "--anti_alias_pooling",
                       "1"])[0]
  if config.chunk_size != chunk:
    raise AssertionError(f"kid-running config: chunk {config.chunk_size}")
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  registry = SessionRegistry(config, device=dev)
  httpd = make_server(registry, "127.0.0.1", 0)
  server = threading.Thread(target=httpd.serve_forever, daemon=True)
  server.start()
  base = f"http://127.0.0.1:{httpd.server_port}"
  try:
    codes, answers = {}, {}
    for path in ("/healthz", "/meta"):
      codes[path], _, body = _http(base + path)
      answers[path] = json.loads(body)
    session = registry.get()
    frame = 24
    pose = np.asarray(session.data.c2w[frame], np.float32)
    req = {"c2w": pose.tolist(), "frame_idx": frame, "format": "npy"}
    secs, frames, launches = {}, {}, {}
    for label, body in (("cold", req), ("warm", req),
                        ("stride 4, rgb_dy", dict(req, stride=4,
                                                  layer="rgb_dy"))):
      _zero_counts()
      t0 = time.perf_counter()
      codes[label], _, blob = _http(base + "/render", body)
      secs[label] = time.perf_counter() - t0
      launches[label] = _read_counts()
      frames[label] = np.load(io.BytesIO(blob)) if codes[label] == 200 else (
          blob)
    hits, misses = (session.stats["featmap_cache_hits"],
                    session.stats["featmap_cache_misses"])
    _zero_counts()
    t0 = time.perf_counter()
    codes["stream"], headers, blob = _http(base + "/stream", {
        "path": "wander", "render_idx": frame, "num_frames": 4})
    stream_s = (time.perf_counter() - t0) / 4
    stream_launches = _read_counts()
    pngs = [png.decode(p) for p in _parts(blob)]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step = session.step
  finally:
    httpd.shutdown()
    httpd.server_close()
    server.join()
  n4 = -(-((h + 3) // 4) * ((w + 3) // 4) // chunk)
  stride4 = dict({k: 0 for k in per_frame}, K1=2 * n4, K2=n4, K3=n4)
  ok = (all(v == 200 for v in codes.values())
        and answers["/healthz"] == {"status": "ok", "checkpoint_step": step}
        and (answers["/meta"]["height"], answers["/meta"]["width"]) == (h, w)
        and launches["cold"] == launches["warm"] == per_frame
        and launches["stride 4, rgb_dy"] == stride4
        and stream_launches == {k: 4 * v for k, v in per_frame.items()}
        and (hits, misses) == (2, 1)
        and headers["X-Frame-Count"] == "4" and len(pngs) == 4
        and all(p.shape == (h, w, 3) for p in pngs)
        and frames["cold"].shape == frames["warm"].shape == (h, w, 3)
        and frames["stride 4, rgb_dy"].shape == ((h + 3) // 4,
                                                 (w + 3) // 4, 3)
        and all(np.isfinite(f).all() for f in frames.values()))
  if not ok:
    raise AssertionError(f"serve: statuses {codes}, launches {launches}, "
                         f"stream launches {stream_launches}, cache hits "
                         f"{hits} misses {misses}, {len(pngs)} parts")
  # one served chunk against the plain path, from the session's own
  # template and weights (the middle chunk of the frame)
  state = session._frames[frame]
  camera = make_camera(h, w, session.data.intrinsics[frame], pose)
  i = n_chunks // 2
  rgb, err, k2_err = _chunk_vs_plain(session.model, session.cfg,
                                     state["template"], camera, dev, chunk, i,
                                     fm=state["featmaps"])
  served = frames["warm"].reshape(-1, 3)[i * chunk:(i + 1) * chunk]
  same = float(np.abs(served - rgb).max())
  if not (err <= 3e-2 and same <= 1e-3):
    raise AssertionError(f"served chunk: kernel vs plain rgb {err}, served "
                         f"vs the chunk rendered again {same}")
  del registry, session, state
  torch.cuda.empty_cache()
  print(f"serve launches per full-frame request: "
        f"{ {k: per_frame[k] for k in ('K1', 'K2', 'K3')} } ({n_chunks} "
        f"chunks of {chunk}); statuses {codes}", flush=True)
  print(f"serve: cold {secs['cold']:.3f} s per request (feature maps "
        f"encoded), warm {secs['warm']:.3f} s (cache hit), stride 4 "
        f"{secs['stride 4, rgb_dy']:.3f} s, {stream_s:.3f} s per streamed "
        f"frame (4-pose wander path, PNG parts); cache hits {hits}, misses "
        f"{misses}; peak memory {peak_gib:.2f} GiB; checkpoint step {step} "
        f"at {h}x{w} [{card}]", flush=True)
  print(f"serve chunk {i} ({chunk} rays) vs the plain path: rgb max abs "
        f"{err:.3g}, K2 max abs {k2_err:.3g}; the served frame's chunk vs "
        f"the chunk rendered again {same:.3g}", flush=True)

  # the render CLI on a 12-frame scene with a seeded snapshot at the kid
  # config as it is (anti-alias pooling off: K2's other branch)
  with tempfile.TemporaryDirectory() as root:
    t0 = time.perf_counter()
    write_synthetic_scene(root, "scene", num_frames=cli_frames, height=h,
                          width=w)
    args = ["--config", kid, "--folder_path", root, "--train_scenes",
            "scene", "--rootdir", root, "--render_idx", "-1",
            "--video_out", ""]
    config = parse_args(args)[0]
    config.num_frames = cli_frames
    cfg = config.render_settings("mono")
    model = MonoModel(cfg, num_frames=cli_frames, seed=SEED)
    ckpt.save_checkpoint(config.out_folder(), 0, model.state_dict())
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = cli_render.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = _read_counts()
    cli_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ch, cw = int(h * 0.03), int(w * 0.03)
    imgs = [png.read(p) for p in res["frames"]]
    if not (len(imgs) == cli_frames and not cfg.anti_alias_pooling
            and all(m.shape == (h - 2 * ch, w - 2 * cw, 3) for m in imgs)
            and res["video"] is None
            and cli_launches == {k: cli_frames * v
                                 for k, v in per_frame.items()}):
      raise AssertionError(f"render cli: {len(imgs)} frames "
                           f"{[m.shape for m in imgs][:2]}, launches "
                           f"{cli_launches}")
    # its first frame's middle chunk against the plain path: the same
    # template (a fresh generator draws the first frame's virtual views)
    data = MonocularSceneData(config, "scene")
    template = cli_render.render_batch_template(
        data, 3, config.num_source_views, config.num_vv,
        np.random.RandomState(0))
    intr, c2w = parse_llff_pose(data.render_poses[0])
    _, cli_err, cli_k2 = _chunk_vs_plain(model, cfg, template,
                                         make_camera(h, w, intr, c2w), dev,
                                         chunk, n_chunks // 2)
    if cli_err > 3e-2:
      raise AssertionError(f"render cli chunk: kernel vs plain rgb {cli_err}")
    del model, data, template
  torch.cuda.empty_cache()
  print(f"render cli: {cli_frames} PNGs of {h - 2 * ch}x{w - 2 * cw} (3% "
        f"crop) on the stabilization path, {np.mean(res['seconds']):.3f} "
        f"s/frame (min {min(res['seconds']):.3f}, max "
        f"{max(res['seconds']):.3f}; template, feature maps, {n_chunks} "
        f"chunks, PNG), the CLI {cli_s:.1f} s, peak memory {cli_peak:.2f} GiB; the "
        f"scene and snapshot written in {write_s:.1f} s; launches "
        f"{ {k: cli_launches[k] for k in ('K1', 'K2', 'K3')} } [{card}]",
        flush=True)
  print(f"render cli chunk (anti-alias pooling off) vs the plain path: rgb "
        f"max abs {cli_err:.3g}, K2 max abs {cli_k2:.3g}", flush=True)
  print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
  return {k: per_frame[k] for k in ("K1", "K2", "K3")}, cli_k2


def _preprocess_frame(dense, cvd, i, frames, h, w):
  """Phase 12a, frame i, in a worker process: the monocular layout's files
  of ConsistentScene(frames, h, w) (images, disparity, masks, the +-1..3
  flows), its images/ frame replaced by a 2h x 2w render of the same
  camera (the focal doubled, so INTER_AREA shrinks at a whole ratio), and
  a dynamic-video-depth npz in the optimizer's layout (depth [1,1,h/2,w/2]
  from the scene, K transposed [1,1,1,3,3], cam_c2w [1,4,4] OpenCV).
  Returns the scene's own poses_bounds row."""
  from dynibar_tpu_torch.data import png
  from dynibar_tpu_torch.data.synthetic_scene import ConsistentScene
  scene = ConsistentScene(frames, h, w)
  row, _ = scene._write_frame(dense, i, scene.c2w)
  big = ConsistentScene(frames, 2 * h, 2 * w)
  rgb, _, _ = big.render(big.c2w(i), float(i))
  png.write(os.path.join(dense, "images", f"{i:05d}.png"),
            (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
  small = ConsistentScene(frames, h // 2, w // 2)
  _, depth, _ = small.render(small.c2w(i), float(i))
  k = np.array([[small.f, 0, small.w / 2.0], [0, small.f, small.h / 2.0],
                [0, 0, 1.0]])
  np.savez(os.path.join(cvd, f"frame{i:05d}.npz"), depth=depth[None, None],
           K=k.T[None, None, None], cam_c2w=scene.c2w(i)[None])
  return row


def _vv_check(dev, dense, frame, h, w, num_vv, scene):
  """Phase 12c, one frame: its virtual views' splats again on the card and
  through the CPU (forward_warp_rgbd's inputs, splat_inputs), rgb within
  2e-3 on the 0-255 scale and alpha within 1e-5; the CLI's PNGs equal to
  the CPU's except at ties (the CPU's alpha within 1e-5 of 0.5, spread by
  the erosion, or its value within 1e-3 of a truncation step), ties where
  the f64 splat does not sit on the step under 0.1% of the pixels; each
  view's masked PSNR against the scene's exact render at its pose.
  Returns (rgb err, alpha err, ties, exact ties, pixels, PSNRs)."""
  from dynibar_tpu_torch.cli import render_source_vv as rsv
  from dynibar_tpu_torch.cli import save_monocular_cameras as smc
  from dynibar_tpu_torch.data import llff, png
  from dynibar_tpu_torch.ops.splat import softmax_splat
  rows = np.load(os.path.join(dense, "poses_bounds_cvd.npy"))
  poses = rows[:, :-2].reshape(-1, 3, 5)
  bd_scale = float(rows[:, -2].min()) * 0.75
  name = f"{frame:05d}"
  rgb255 = png.read(os.path.join(dense, f"images_{w}x{h}", name + ".png")
                    ).astype(np.float32)
  disp = np.load(os.path.join(dense, "disp", name + ".npy"))
  f = poses[frame, 2, 4]
  k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
  alpha = rsv.sobel_alpha(((1.0 / np.maximum(disp, 1e-8)) / 10.0
                           ).astype(np.float32))
  vv = llff.render_vv_wander_paths(poses[frame], bd_scale, num_vv // 2)
  saved = np.load(os.path.join(dense, "source_vv_poses.npy"))[..., frame]
  if not np.array_equal(saved, vv.astype(np.float32)):
    raise AssertionError(f"preprocess: frame {frame}'s saved poses differ")
  rgb_err = a_err = 0.0
  ties = exact_ties = pixels = 0
  psnrs = []
  for v in range(num_vv):
    dst = smc.llff_from_opencv(vv[v])
    ins = rsv.splat_inputs(rgb255, alpha, disp, k,
                           smc.llff_from_opencv(poses[frame, :, :4]), dst)
    outs = [softmax_splat(*[torch.from_numpy(x).to(device, dtype)
                            for x in ins]).cpu().numpy()
            for device, dtype in ((dev, torch.float32),
                                  ("cpu", torch.float32),
                                  (dev, torch.float64))]
    card, cpu, f64 = outs
    rgb_err = max(rgb_err, float(np.abs(card[..., :3] - cpu[..., :3]).max()))
    a_err = max(a_err, float(np.abs(card[..., 3] - cpu[..., 3]).max()))
    value = np.clip(cpu[..., :3] / 255.0, 0.0, 1.0) * 255
    mask = rsv._disk1_erosion(cpu[..., 3] > 0.5)
    want = (np.clip(value / 255 * mask[..., None], 0, 1) * 255
            ).astype(np.uint8)
    written = png.read(os.path.join(dense, f"source_virtual_views_{w}x{h}",
                                    name, f"{v:02d}.png"))
    near = np.pad(np.abs(cpu[..., 3] - 0.5) < 1e-5, 1)   # the erosion's
    alpha_tie = (near[1:-1, 1:-1] | near[:-2, 1:-1] | near[2:, 1:-1]
                 | near[1:-1, :-2] | near[1:-1, 2:])      # cross
    step = np.abs(value - np.rint(value)) < 1e-3
    v64 = np.clip(f64[..., :3] / 255.0, 0.0, 1.0) * 255
    on_step = np.abs(v64 - np.rint(v64)) < 1e-6
    diff = written != want
    if (diff & ~(step | alpha_tie[..., None])).any():
      raise AssertionError(f"preprocess: frame {frame} view {v}: "
                           f"{int(diff.any(-1).sum())} pixels differ from "
                           f"the CPU's outside ties")
    ties += int((diff & ~on_step).any(-1).sum())
    exact_ties += int((diff & on_step).any(-1).sum())
    pixels += h * w
    gt = scene.render(np.vstack([dst, [0, 0, 0, 1.0]]), float(frame))[0]
    seen = rsv._disk1_erosion(card[..., 3] > 0.5)
    mse = np.mean((written[seen] / 255.0 - gt[seen]) ** 2)
    psnrs.append(float(-10 * np.log10(mse)))
  if not (rgb_err <= 2e-3 and a_err <= 1e-5 and ties < 1e-3 * pixels):
    raise AssertionError(f"preprocess: frame {frame} card vs CPU: rgb "
                         f"{rgb_err}, alpha {a_err}, ties {ties} of "
                         f"{pixels} pixels")
  return rgb_err, a_err, ties, exact_ties, pixels, psnrs


def _preprocess_phase(card, dev, h, w, frames=48, num_vv=8, n_rand=3072,
                      workers=8):
  """Phase 12: preprocess a scene on the card, then train on it.  (a) A
  ConsistentScene's frames in the monocular layout, written by `workers`
  processes (_preprocess_frame); (b) cli/save_monocular_cameras, then
  cli/render_source_vv on the card, with their checks, s/frame, the
  virtual views' PhaseTimer split, peak memory and one frame's splats
  traced; (c) frames 0 and frames - 1 held against the CPU (_vv_check);
  (d) cli/train on the preprocessed folder on the default routes, one
  bootstrap epoch.  Returns the launches of the training run."""
  import concurrent.futures
  import glob
  import multiprocessing
  import tempfile
  from dynibar_tpu_torch.cli import render_source_vv as rsv
  from dynibar_tpu_torch.cli import save_monocular_cameras as smc
  from dynibar_tpu_torch.cli import train as cli_train
  from dynibar_tpu_torch.data import llff, png
  from dynibar_tpu_torch.data.synthetic_scene import ConsistentScene
  from dynibar_tpu_torch.utils.profiling import PhaseTimer, trace
  t_phase = time.perf_counter()
  name = "preprocessed"
  scene = ConsistentScene(frames, h, w)
  with tempfile.TemporaryDirectory() as root:
    # ---- 12a: the inputs ----
    dense = os.path.join(root, name, "dense")
    cvd = os.path.join(root, "cvd")
    for sub in ("images", f"images_{w}x{h}", "disp", "flow_i1", "flow_i2",
                "flow_i3", "dynamic_masks", "static_masks"):
      os.makedirs(os.path.join(dense, sub))
    os.makedirs(cvd)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
      rows = np.stack(list(pool.map(
          _preprocess_frame, [dense] * frames, [cvd] * frames,
          range(frames), [frames] * frames, [h] * frames, [w] * frames)))
    print(f"preprocess: wrote a {frames}-frame {h}x{w} ConsistentScene "
          f"(masks, flows) with {2 * h}x{2 * w} frames and a "
          f"dynamic-video-depth output at {h // 2}x{w // 2} in "
          f"{time.perf_counter() - t0:.1f} s ({workers} processes)",
          flush=True)

    # ---- 12b: the two CLIs ----
    log = io.StringIO()                 # the CLIs' per-frame lines
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
      smc.main(["--data_path", dense, "--cvd_path", cvd, "--height", str(h)])
    save_s = (time.perf_counter() - t0) / frames
    got = np.load(os.path.join(dense, "poses_bounds_cvd.npy"))
    pose_err = float(np.abs(got[:, :15] - rows[:, :15]).max())
    depths = [np.load(os.path.join(cvd, f"frame{i:05d}.npz"))["depth"]
              for i in range(frames)]
    bounds = np.array([[np.percentile(d, 5), np.percentile(d, 95)]
                       for d in depths])
    bound_err = float(np.abs(got[:, 15:] - bounds).max())
    img = png.read(os.path.join(dense, f"images_{w}x{h}", "00000.png"))
    disp = np.load(os.path.join(dense, "disp", "00000.npy"))
    if not (got.shape == (frames, 17) and got.dtype == np.float64
            and pose_err <= 1e-9 and bound_err == 0.0
            and img.shape == (h, w, 3) and disp.shape == (h, w)):
      raise AssertionError(f"save_monocular_cameras: poses {got.shape} "
                           f"{got.dtype}, pose err {pose_err}, bound err "
                           f"{bound_err}, image {img.shape}, disp "
                           f"{disp.shape}")
    print(f"save_monocular_cameras: {save_s:.4f} s/frame ({2 * h}x{2 * w} "
          f"-> {h}x{w}, host); poses vs the scene's cameras max abs "
          f"{pose_err:.3g}, bounds vs the depth percentiles {bound_err:.3g} "
          f"[{card}]", flush=True)

    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(log):
      res = rsv.main(["--data_path", dense, "--height", str(h), "--num_vv",
                      str(num_vv)])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timer = res["timer"]
    vv_poses = np.load(os.path.join(dense, "source_vv_poses.npy"))
    n_png = len(glob.glob(os.path.join(res["out_dir"], "*", "*.png")))
    if not (vv_poses.shape == (num_vv, 3, 4, frames)
            and vv_poses.dtype == np.float32 and n_png == frames * num_vv
            and timer.counts["splat"] == frames * num_vv):
      raise AssertionError(f"render_source_vv: poses {vv_poses.shape} "
                           f"{vv_poses.dtype}, {n_png} PNGs, "
                           f"{dict(timer.counts)} phases")
    split = ", ".join(f"{k} {timer.totals[k] / frames:.4f}"
                      for k in timer.totals)
    print(f"render_source_vv: {res['seconds'] / frames:.4f} s/frame "
          f"({num_vv} views of {h}x{w}); per frame: {split} s (read, "
          f"filters, geometry, erode and write on the host; splat: to the "
          f"card, softmax_splat, back); splat "
          f"{1e3 * timer.summary()['splat']:.3f} ms per view; peak "
          f"{peak:.3f} GiB [{card}]", flush=True)

    trace_dir = os.path.join(root, "trace")
    frame_timer = PhaseTimer()
    with trace(trace_dir):
      rgb255 = img.astype(np.float32)
      rows_p = got[:, :-2].reshape(-1, 3, 5)
      k = np.array([[rows_p[0, 2, 4], 0, w / 2.0],
                    [0, rows_p[0, 2, 4], h / 2.0], [0, 0, 1.0]])
      alpha = rsv.sobel_alpha(((1.0 / np.maximum(disp, 1e-8)) / 10.0
                               ).astype(np.float32))
      vv = llff.render_vv_wander_paths(
          rows_p[0], float(got[:, -2].min()) * 0.75, num_vv // 2)
      for v in range(num_vv):
        rsv.forward_warp_rgbd(rgb255, alpha, disp, k,
                              smc.llff_from_opencv(rows_p[0, :, :4]),
                              smc.llff_from_opencv(vv[v]), device=dev,
                              timer=frame_timer)
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    named = False
    if len(files) == 1:
      with open(files[0]) as fh:
        named = '"softmax_splat"' in fh.read()
    if not named:
      raise AssertionError(f"trace: files {files}, region named {named}")
    print(f"trace: {os.path.basename(files[0])} "
          f"({os.path.getsize(files[0])} bytes) names softmax_splat; "
          f"{num_vv} splats traced, {1e3 * frame_timer.summary()['splat']:.3f}"
          f" ms per view under the profiler", flush=True)

    # ---- 12c: the card against the CPU ----
    for frame in (0, frames - 1):
      rgb_err, a_err, ties, exact, pixels, psnrs = _vv_check(
          dev, dense, frame, h, w, num_vv, scene)
      print(f"preprocess frame {frame}: card vs CPU splat rgb max abs "
            f"{rgb_err:.3g}, alpha {a_err:.3g}; PNGs equal but {ties} + "
            f"{exact} tie pixels of {pixels} (the second on a truncation "
            f"step in f64); masked PSNR vs the exact render per view "
            f"{[round(p, 2) for p in psnrs]} dB", flush=True)

    # ---- 12d: the training CLI on the preprocessed folder ----
    args = ["--folder_path", root, "--train_scenes", name, "--rootdir",
            root, "--expname", "preprocessed", "--training_height", str(h),
            "--N_rand", str(n_rand), "--N_samples", "64",
            "--num_source_views", "7", "--num_vv", "3", "--num_basis", "6",
            "--init_decay_epoch", "2", "--n_iters", "0",
            "--compute_dtype", "bfloat16", "--i_img", str(10 * frames),
            "--i_weights", str(10 * frames), "--i_print", "1",
            "--workers", "4", "--chunk_size", "4096"]
    _zero_counts()
    with contextlib.redirect_stdout(log):
      out = cli_train.main(args)["out_folder"]
    torch.cuda.synchronize()
    launches = _read_counts()
    logs = os.path.join(root, "logs", os.path.basename(out))
    with open(os.path.join(logs, "metrics.jsonl")) as fh:
      curve = [r["bootstrap/loss"] for r in map(json.loads, fh)
               if "bootstrap/loss" in r]
    boot = dict(_cli_phases(logs))["bootstrap"]
    first, last = np.mean(curve[:12]), np.mean(curve[-12:])
    print(f"preprocess cli: {boot['steps']:.0f} bootstrap steps, "
          f"{boot['seconds'] / boot['steps']:.4f} s/step, "
          f"{boot['wait_s']:.2f} s getting batches from the pipeline; loss "
          f"mean of the first 12 {first:.5f}, of the last 12 {last:.5f}; "
          f"launches { {k: n for k, n in launches.items() if n} } [{card}]",
          flush=True)
    # a bootstrap step trains the static model: its static aggregator
    # forward and backward, and the dynamic forward (with residuals) of the
    # loss's render, which passes it no gradient
    want = {k: frames if k in ("K2r", "K5a", "K5b", "K3r") else 0
            for k in launches}
    if not (boot["steps"] == frames and len(curve) == frames
            and np.isfinite(curve).all() and last < first
            and launches == want):
      raise AssertionError(f"preprocess cli: {boot}, losses {curve}, "
                           f"launches {launches}")
  print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
  return launches


def _mesh_steps(mesh, dev, make, step_fn, batches, weights, cfg, t_cfg):
  """Three steps of one model on the mesh.  Rank 0 keeps each step's
  starting state and runs a one-card twin from it twice, on the same
  global batch from a generator in the same state: the sharded step's
  loss and per-group gradients against the first, and the two one-card
  steps against each other (the floor that atomics set on one card).
  Returns the launches and seconds of each sharded step, the comparisons
  and whether the ranks' parameters are identical after the steps."""
  model, opt = make()
  ref_model, ref_opt = make() if mesh.is_main else (None, None)
  gen = torch.Generator(dev).manual_seed(SEED + 50)
  ref_gen = torch.Generator(dev).manual_seed(SEED + 50)

  def group_grads(m):
    return {k: torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).reshape(-1)
                           for p in ps]).float()
            for k, ps in m.param_groups().items()}

  def rel(got, want):
    return {k: (0.0 if float(want[k].norm()) == 0.0 == float(got[k].norm())
                else float((got[k] - want[k]).norm() / want[k].norm()))
            for k in want}

  def one_card(start, batch, gen_state):
    # a deep copy: the optimizer's load_state_dict keeps the tensors it
    # is given, and the twin's step would update them in place
    ref_model.load_state_dict(start[0])
    ref_opt.load_state_dict(copy.deepcopy(start[1]))
    ref_gen.set_state(gen_state)
    loss, _, _ = step_fn(ref_model, ref_opt, batch, weights, cfg, t_cfg,
                         generator=ref_gen)
    return float(loss), group_grads(ref_model)

  res = {"launches": [], "secs": [], "loss_rel": [], "group_rel": [],
         "floor": []}
  for batch in batches:
    if ref_model is not None:
      start = (copy.deepcopy(model.state_dict()),
               copy.deepcopy(opt.state_dict()))
      gen_state = ref_gen.get_state()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    loss, metrics, _ = step_fn(model, opt, batch, weights, cfg, t_cfg,
                               generator=gen, mesh=mesh)
    torch.cuda.synchronize()
    res["secs"].append(time.perf_counter() - t0)
    res["launches"].append(_read_counts())
    if not all(bool(torch.isfinite(v)) for v in metrics.values()):
      raise AssertionError(f"mesh step: non-finite metrics {metrics}")
    if ref_model is None:
      continue
    got = group_grads(model)
    want_loss, want = one_card(start, batch, gen_state)
    again_loss, again = one_card(start, batch, gen_state)
    res["loss_rel"].append(abs(float(loss) - want_loss) / abs(want_loss))
    res["group_rel"].append(rel(got, want))
    res["floor"].append(rel(again, want))
  flat = torch.cat([v.detach().reshape(-1).float()
                    for v in model.state_dict().values()])
  every = mesh.gather_rows(flat[None])
  if mesh.is_main:
    res["ranks_equal"] = bool(torch.equal(every[0], every[1]))
  del model, opt, ref_model, ref_opt
  torch.cuda.empty_cache()
  return res


def _mesh_rank(rank, workdir, cli_root, snapshot, h, w, n_rand):
  """One rank of phase 13 (a spawned process; both share the one card
  over gloo): the sharded train steps, eval frame and served frame, each
  against one card's on rank 0; the results go to <workdir>/rank<r>.pt."""
  import threading
  from dynibar_tpu_torch.cli.train import parse_args
  from dynibar_tpu_torch.config import (DynibarConfig, RenderSettings,
                                        TrainSettings, mono_render_settings)
  from dynibar_tpu_torch.core.cameras import make_camera
  from dynibar_tpu_torch.data.ray_batch import (synthetic_ff_batch,
                                                synthetic_mono_batch)
  from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel
  from dynibar_tpu_torch.parallel.mesh import training_mesh
  from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                     render_image_ff,
                                                     render_image_mono)
  from dynibar_tpu_torch.serve.registry import SessionRegistry
  from dynibar_tpu_torch.serve.server import make_server
  from dynibar_tpu_torch.serve.session import follow, stop_followers
  from dynibar_tpu_torch.train import losses, trainer
  from dynibar_tpu_torch.utils.device import to_device
  mesh = training_mesh(DynibarConfig(mesh_shape="2"), None,
                       init_method=f"file://{workdir}/store", rank=rank,
                       world_size=2)
  dev = mesh.device
  out = {"backend": mesh.backend, "device": str(dev)}
  t_cfg = TrainSettings()

  # ---- 13a: the sharded train steps, three each ----
  mcfg = mono_render_settings(num_source_views=7, num_vv=3, n_samples=64,
                              num_basis=6, compute_dtype="bfloat16")
  batches = [to_device(synthetic_mono_batch(mcfg, n_rays=n_rand, h=h, w=w,
                                            num_frames=48, seed=SEED + k),
                       dev) for k in range(3)]
  # phase 6's step as it is (bf16 sampling), then each route with the
  # sampling in f32 (the kernels take bf16 operands either way)
  for label, route, dtype in (("mono pallas_split bf16", "pallas_split",
                               "bfloat16"),
                              ("mono pallas_split f32", "pallas_split",
                               "float32"),
                              ("mono pallas f32", "pallas", "float32")):
    st_bwd, dy_bwd = MONO_ROUTES[route]
    rcfg = dataclasses.replace(mcfg, fused_st_bwd_impl=st_bwd,
                               fused_bwd_impl=dy_bwd, compute_dtype=dtype)

    def make_mono():
      m = MonoModel(rcfg, num_frames=48, seed=SEED).train_all()
      return m, trainer.make_mono_optimizer(m, t_cfg)
    out[label] = _mesh_steps(
        mesh, dev, make_mono, trainer.mono_train_step, batches,
        losses.schedule_weights(t_cfg, 2), rcfg, t_cfg)
  del batches
  fcfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                        num_views_anchor=6, num_views_static=11, num_basis=6,
                        inv_uniform=True, compute_dtype="float32")

  def make_ff():
    m = FFModel(fcfg, num_frames=48, seed=SEED).train_fine()
    return m, trainer.make_ff_optimizer(m, t_cfg)
  batches = [to_device(synthetic_ff_batch(fcfg, n_rays=n_rand, h=h, w=w,
                                          num_frames=48, seed=SEED + k), dev)
             for k in range(3)]
  out["ff f32"] = _mesh_steps(mesh, dev, make_ff, trainer.ff_train_step,
                              batches, losses.schedule_weights(t_cfg, 0),
                              fcfg, t_cfg)
  del batches
  torch.cuda.empty_cache()

  # ---- 13b: one FF eval frame at the eval config's settings ----
  root = os.path.dirname(os.path.abspath(__file__))
  ecfg = DynibarConfig.from_file(os.path.join(
      root, "configs_nvidia", "eval_balloon1_long.txt")).render_settings("ff")
  emodel = FFModel(ecfg, num_frames=48, seed=SEED)
  rb = synthetic_ff_batch(ecfg, n_rays=4, h=h, w=w, num_frames=48, seed=SEED)
  frame = full_image_ray_batch(rb, rb["camera"], device=dev)
  with torch.no_grad():
    c, f = emodel.encode_featmaps(frame["src_rgbs"], frame["static_src_rgbs"])
  torch.cuda.synchronize()
  _zero_counts()
  t0 = time.perf_counter()
  got = render_image_ff(emodel, frame, c, f, ecfg, 8192, h, w, device=dev,
                        mesh=mesh)
  torch.cuda.synchronize()
  out["eval"] = {"secs": time.perf_counter() - t0,
                 "launches": _read_counts()}
  if mesh.is_main:
    t0 = time.perf_counter()
    want = render_image_ff(emodel, frame, c, f, ecfg, 8192, h, w, device=dev)
    torch.cuda.synchronize()
    out["eval"]["one_card_secs"] = time.perf_counter() - t0
    out["eval"]["max_abs"] = max(
        float(np.abs(got[n][k] - want[n][k]).max())
        for n in want for k in ("rgb", "depth", "mask"))
    out["eval"]["finite"] = all(np.isfinite(got[n][k]).all()
                                for n in got for k in got[n])
  del emodel, frame, c, f
  torch.cuda.empty_cache()

  # ---- 13b: the served mono frame through the server with a follower ----
  kid = os.path.join(root, "configs", "test_kid-running.txt")
  config = parse_args(["--config", kid, "--folder_path", cli_root,
                       "--train_scenes", "scene", "--rootdir", cli_root,
                       "--ckpt_path", snapshot, "--anti_alias_pooling",
                       "1"])[0]
  registry = SessionRegistry(config, device=dev)
  if not mesh.is_main:
    out["followed"] = follow(registry, mesh)
  else:
    httpd = make_server(registry, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
      session = registry.get()
      idx = 24
      pose = np.asarray(session.data.c2w[idx], np.float32)
      req = {"c2w": pose.tolist(), "frame_idx": idx, "format": "npy"}
      codes, secs = [], []
      _zero_counts()
      for body in (req, dict(req, stride=4, layer="rgb_dy")):
        t0 = time.perf_counter()
        code, _, blob = _http(base + "/render", body)
        secs.append(time.perf_counter() - t0)
        codes.append(code)
        if len(codes) == 1:
          launches = _read_counts()
          served = np.load(io.BytesIO(blob)) if code == 200 else None
    finally:
      httpd.shutdown()
      httpd.server_close()
      server.join()
      stop_followers(mesh)
    state = session._frame_state(idx)
    pose4 = np.eye(4, dtype=np.float32)
    pose4[:pose.shape[0]] = pose
    camera = make_camera(session.height, session.width,
                         session.data.intrinsics[idx], pose4)
    one = render_image_mono(
        session.model, full_image_ray_batch(state["template"], camera,
                                            device=dev),
        state["featmaps"], session.cfg, config.chunk_size, session.height,
        session.width, device=dev)["outputs_coarse_ref"]["rgb"]
    out["serve"] = {"codes": codes, "secs": secs, "launches": launches,
                    "max_abs": (float(np.abs(served - one).max())
                                if served is not None else float("nan")),
                    "finite": served is not None
                    and bool(np.isfinite(served).all())}
  torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def _mesh_phase(card, h, w, cli_root, snapshot, n_rand):
  """Phase 13: the mesh rehearsed on the one card.  Two spawned ranks over
  gloo (13a: the mono step on pallas_split and pallas and the FF fine step,
  three steps each against one card's; 13b: the FF eval frame and the
  served mono frame), then (13c) the training CLI under torchrun on NCCL.
  Returns rank 0's launches per step / frame, by kernel."""
  import multiprocessing
  import tempfile
  t_phase = time.perf_counter()
  torch.cuda.empty_cache()
  with tempfile.TemporaryDirectory() as workdir:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, workdir, cli_root,
                                                  snapshot, h, w, n_rand))
             for r in range(2)]
    for p in procs:
      p.start()
    deadline = time.monotonic() + 600
    while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
           and not any(p.exitcode not in (None, 0) for p in procs)):
      time.sleep(0.5)
    for p in procs:
      if p.is_alive():
        p.kill()
      p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
      raise AssertionError(f"mesh ranks exited with {codes}")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
  r0, r1 = ranks
  print(f"mesh: 2 ranks on {r0['device']} / {r1['device']} over "
        f"{r0['backend']} [{card}]", flush=True)
  mesh_launches = {}
  for label in ("mono pallas_split bf16", "mono pallas_split f32",
                "mono pallas f32", "ff f32"):
    res, other = r0[label], r1[label]
    launches = res["launches"]
    if (any(n != launches[0] for n in launches + other["launches"])
        or launches[0]["K2r"] != 1):
      raise AssertionError(f"mesh step ({label}): launches per rank and "
                           f"step {launches} / {other['launches']}")
    mesh_launches[label] = launches[0]
    worst, floor = ({k: max(g[k] for g in res[key])
                     for k in res[key][0]} for key in ("group_rel", "floor"))
    # 1e-4 per group; at bf16 sampling each rank rounds its part of the
    # feature maps' gradient to bf16 (a ulp is 2^-8 of a value), one card
    # the whole, so the groups under the sampler get half a bf16 ulp
    bars = {k: (2e-3 if "bf16" in label and k.startswith("feature_net")
                else 1e-4) for k in worst}
    print(f"mesh step ({label}, N_rand {n_rand}, {n_rand // 2} rays per "
          f"rank): loss rel to one card per step "
          f"{[f'{x:.2e}' for x in res['loss_rel']]}; worst gradient "
          f"rel-norm per group {({k: f'{v:.2e}' for k, v in worst.items()})}"
          f", one card against itself "
          f"{({k: f'{v:.2e}' for k, v in floor.items()})}; ranks' "
          f"parameters identical after 3 steps: {res['ranks_equal']}; "
          f"launches per rank and step "
          f"{ {k: n for k, n in launches[0].items() if n} }; s/step per "
          f"rank (two ranks time-slice one card) "
          f"{[round(s, 4) for s in res['secs']]} / "
          f"{[round(s, 4) for s in other['secs']]} [{card}]", flush=True)
    if not (res["ranks_equal"] and max(res["loss_rel"]) <= 1e-5
            and all(worst[k] <= bars[k] for k in worst)):
      raise AssertionError(f"mesh step ({label}) differs from one card's")
  ev, sv = r0["eval"], r0["serve"]
  for label, res in (("eval frame", ev), ("served frame", sv)):
    mesh_launches[label] = res["launches"]
  print(f"mesh eval frame ({h}x{w}, 64 + 64 samples, bf16, mask_rgb 0, "
        f"chunk 8192): 2 ranks {ev['secs']:.3f} / {r1['eval']['secs']:.3f} "
        f"s, one card {ev['one_card_secs']:.3f} s; max abs vs one card "
        f"{ev['max_abs']:.3g}; rank 0 launches "
        f"{ {k: n for k, n in ev['launches'].items() if n} } [{card}]",
        flush=True)
  print(f"mesh served frame (kid-running settings, frame 24's pose, npy): "
        f"statuses {sv['codes']}, {sv['secs'][0]:.3f} s (stride 4 "
        f"{sv['secs'][1]:.3f} s), the follower rendered "
        f"{r1['followed']} requests; max abs vs one card {sv['max_abs']:.3g}"
        f"; rank 0 launches "
        f"{ {k: n for k, n in sv['launches'].items() if n} } [{card}]",
        flush=True)
  # K2/K3's bars (phase 2): the frames' chunks meet the kernels as they do
  # on one card, so they are expected to agree exactly
  if not (ev["finite"] and ev["max_abs"] <= 2e-2 and sv["finite"]
          and sv["codes"] == [200, 200] and r1["followed"] == 2
          and sv["max_abs"] <= 2e-2):
    raise AssertionError(f"mesh frames: eval {ev}, serve {sv}")

  # ---- 13c: the training CLI under torchrun, one rank on NCCL ----
  root = os.path.dirname(os.path.abspath(__file__))
  with tempfile.TemporaryDirectory() as run_root:
    args = ["--folder_path", cli_root, "--train_scenes", "scene",
            "--rootdir", run_root, "--training_height", str(h), "--N_rand",
            str(n_rand), "--N_samples", "64", "--num_source_views", "7",
            "--num_vv", "3", "--num_basis", "6", "--init_decay_epoch", "2",
            "--compute_dtype", "bfloat16", "--n_iters", "0", "--i_img",
            "100000", "--i_weights", "100000", "--i_print", "16",
            "--workers", "4", "--mesh_shape", "auto"]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "dynibar_tpu_torch.cli.train"]
        + args, cwd=root, capture_output=True, text=True, timeout=400)
    cli_s = time.perf_counter() - t0
    if run.returncode != 0 or "mesh: 1 rank(s) over nccl" not in run.stdout:
      raise AssertionError(f"torchrun cli: rc {run.returncode}\n"
                           f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    logs = [os.path.join(run_root, "logs", d)
            for d in os.listdir(os.path.join(run_root, "logs"))]
    recs = []
    with open(os.path.join(logs[0], "metrics.jsonl")) as fh:
      recs = [json.loads(line) for line in fh]
  boot = [r for r in recs if "bootstrap/loss" in r]
  phase = [r for r in recs if "phase/bootstrap/steps" in r][0]
  if not (phase["phase/bootstrap/steps"] == 48 and len(boot) == 3
          and all(np.isfinite(r["bootstrap/loss"]) for r in boot)):
    raise AssertionError(f"torchrun cli: records {recs}")
  print(f"mesh cli: torchrun --standalone --nproc_per_node 1, mesh_shape "
        f"auto: 'mesh: 1 rank(s) over nccl', 48 bootstrap steps, "
        f"{phase['phase/bootstrap/seconds'] / 48:.4f} s/step, "
        f"{phase['phase/bootstrap/wait_s']:.2f} s getting batches; loss "
        f"at steps 16/32/48 {[round(r['bootstrap/loss'], 5) for r in boot]}"
        f"; the command {cli_s:.1f} s [{card}]", flush=True)
  print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
  return {k: {label: n[k] for label, n in mesh_launches.items()}
          for k in _counters()}


def _mono_convergence_phase(card, dev, steps=300, eval_every=150, frames=24):
  """Phase 14: scripts/port_mono_convergence.py's run on the card at its
  production configuration, compressed schedule (its gate reported, not
  enforced).  Returns the launches of the run (steps and evals)."""
  import tempfile
  from dynibar_tpu_torch.cli.render_monocular import render_batch_template
  from dynibar_tpu_torch.core.cameras import make_camera
  from dynibar_tpu_torch.eval.held_out import final_camera
  from dynibar_tpu_torch.models.dynibar import MonoModel
  from dynibar_tpu_torch.render import render_rays as rr
  from dynibar_tpu_torch.render.render_image import full_image_ray_batch
  from dynibar_tpu_torch.train import trainer
  from dynibar_tpu_torch.utils import checkpoints as ckpt
  t_phase = time.perf_counter()
  script = _load_script("port_mono_convergence")

  # each step's launches, read around the trainer's step (the script
  # calls it through the module, so the counts it keeps are the run's)
  per_step = []
  step_fn = trainer.mono_train_step

  def counted(*args, **kw):
    before = _read_counts()
    out = step_fn(*args, **kw)
    after = _read_counts()
    per_step.append((kw.get("bootstrap", False),
                     {k: after[k] - before[k] for k in after}))
    return out

  with tempfile.TemporaryDirectory() as outdir:
    argv = ["--clip", "1", "--init_decay_epoch", "10", "--frames",
            str(frames), "--steps", str(steps), "--eval_every",
            str(eval_every), "--tag", "smoke", "--outdir", outdir]
    log = io.StringIO()
    trainer.mono_train_step = counted
    try:
      _zero_counts()
      with contextlib.redirect_stdout(log):   # 300 steps: not gated
        res = script.run(script.parse_args(argv))
      torch.cuda.synchronize()
      launches = _read_counts()
    finally:
      trainer.mono_train_step = step_fn
    for line in log.getvalue().splitlines():
      if line.startswith(("schedule:", "wrote scene")):
        print(f"mono convergence {line}", flush=True)

    # (a) a finite, falling loss within the full phase
    full = res["full_losses"]
    first, last = np.mean(full[:25]), np.mean(full[-25:])
    n_boot = len(per_step) - len(full)
    print(f"mono convergence: {n_boot} bootstrap + {len(full)} full steps "
          f"at N_rand {res['config']['N_rand']}, {res['config']['hw']}, "
          f"{frames} frames; "
          f"{res['sec_per_step_mean']:.4f} s/step (a host sync per step), "
          f"peak memory {res['peak_gib']:.2f} GiB; full-phase loss mean of "
          f"the first 25 {first:.5f}, of the last 25 {last:.5f} [{card}]",
          flush=True)
    for rec in res["curve"]:
      print(f"mono convergence eval step {int(rec['step'])}: " + ", ".join(
          f"{k[5:]} {rec[k]:.3f}" for k in sorted(rec)
          if k.startswith("psnr_") and k.endswith("_crop3"))
            + (f", loss {rec['loss']:.5f}" if "loss" in rec else ""),
            flush=True)
    print(f"mono convergence held-out rise (crop 3%, min of the novel "
          f"views; printed, not gated): {res['novel_psnr_rise_db']:+.3f} "
          f"dB; train view {res['train_view_rise_db']:+.3f} dB", flush=True)
    if not (np.isfinite(full).all() and last < first):
      raise AssertionError(f"mono convergence: the full-phase loss did not "
                           f"fall ({first} -> {last})")
    # (b) the train view rose
    if not res["train_view_rise_db"] > 0:
      raise AssertionError(f"mono convergence: train view "
                           f"{res['train_view_rise_db']} dB")
    # (c) every full-phase step launched the default routes' mono step
    # (every bootstrap step: the static pair and the dynamic forward)
    want_full = MONO_LAUNCHES["pallas_split"]
    want_boot = {k: int(k in ("K2r", "K5a", "K5b", "K3r")) for k in want_full}
    for boot, got in per_step:
      if got != (want_boot if boot else want_full):
        kind = "bootstrap" if boot else "full"
        raise AssertionError(f"mono convergence: a {kind} step launched "
                             f"{got}")
    # the evals: 3 views of 3 chunks each (4608 rays), K1 2, K2 1, K3 1
    evals = len(res["curve"]) * 3 * 3
    want = {k: n_boot * want_boot[k] + len(full) * want_full[k]
            for k in want_full}
    want.update(K1=2 * evals, K2=evals, K3=evals)
    if launches != want:
      raise AssertionError(f"mono convergence launches {launches}, want "
                           f"{want}")
    print(f"mono convergence launches per full-phase step "
          f"{ {k: n for k, n in want_full.items() if n} }, per bootstrap "
          f"step { {k: n for k, n in want_boot.items() if n} }; the run "
          f"{ {k: n for k, n in launches.items() if n} }", flush=True)

    # (d) 1024-ray chunks of the held-out views at the trained weights
    # (each view's first, middle and last), through the kernels against
    # the plain path; K2 and K3 alone on each chunk's inputs
    args = script.parse_args(argv)
    scene, config, data = script.build(args)
    cfg = config.render_settings("mono")
    model = MonoModel(cfg, num_frames=data.num_frames, device=dev)
    model.load_state_dict(ckpt.load_checkpoint(
        ckpt.latest_checkpoint(os.path.join(outdir, "ckpt_smoke")),
        map_location=dev)["model"])
    frames_rb = []
    for pose, tau in scene.held_out_cameras():
      idx = int(round(tau))
      template = render_batch_template(data, idx, config.num_source_views,
                                       config.num_vv,
                                       np.random.RandomState(0))
      cam = make_camera(scene.h, scene.w, data.intrinsics[idx],
                        final_camera(scene, data, pose))
      frames_rb.append(full_image_ray_batch(template, cam, device=dev))
  worst, stats, beyond = 0.0, {}, []
  for view, full_rb in enumerate(frames_rb):
    n = full_rb["ray_o"].shape[0]
    for start in (0, n // 2 - 512, n - 1024):
      part = {k: (v[start:start + 1024] if k in ("ray_o", "ray_d", "uv_grid")
                  else v) for k, v in full_rb.items()}
      name = f"novel_{view} rays {start}"
      with torch.no_grad():
        fm = model.encode_featmaps(part["src_rgbs"], part["static_src_rgbs"])
        ker = rr.render_rays_mono(model, part, fm, cfg, device=dev)
        plain = rr.render_rays_mono(model, part, fm, cfg, device=dev,
                                    kernels=False)
        rgb = ker["outputs_coarse_ref"]["rgb"]
        if not torch.isfinite(rgb).all() or rgb.shape != (1024, 3):
          raise AssertionError(f"{name}: rgb not finite or misshapen")
        chunk_err = float((rgb - plain["outputs_coarse_ref"]["rgb"])
                          .abs().max())
        if chunk_err > 3e-2:
          raise AssertionError(f"{name}: kernels vs plain rgb {chunk_err}")
        pts, _, _ = rr.sampling.sample_along_ray(
            part["ray_o"], part["ray_d"], part["depth_range"],
            cfg.n_samples, cfg.inv_uniform, det=True)
        ins = rr.stage_inputs(model, part, fm, cfg, None, pts,
                              kernels=False)
      # K2 and K3 alone: finite, their -1e9 fills exact, within the
      # bf16-twin bar; their values outside phase 2's bars counted (those
      # bars hold at random weights: at trained weights, a sharper trunk
      # in bf16, a few values leave them while the chunks' rgb stays
      # inside 3e-2)
      beyond += _trained_alone(stats, name, model.net_coarse_st,
                               model.net_coarse_dy, ins)
      worst = max(worst, chunk_err)
  print(f"mono convergence at the trained weights, 6 chunks of 1024 rays of "
        f"the held-out views: largest kernels vs plain rgb {worst:.3g} "
        f"[{card}]", flush=True)
  _trained_report(card, "mono convergence at the trained weights", stats,
                  beyond)
  print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
  return launches


def _ff_stage_inputs(model, cfg, rb, coarse, fine):
  """Both FF stages' aggregator inputs, from the plain path: the coarse
  stage's projections and gathers, then importance-resampled depths from
  the plain coarse pass and the fine stage's own projections and gathers;
  (coarse inputs, fine inputs, fine points)."""
  from dynibar_tpu_torch.render import render_rays as rr
  with torch.no_grad():
    pts, z_vals, _ = rr.sampling.sample_along_ray(
        rb["ray_o"], rb["ray_d"], rb["depth_range"], cfg.n_samples,
        cfg.inv_uniform, det=True)
    ins_c = rr.stage_inputs(model, rb, coarse, cfg, "coarse", pts,
                            kernels=False)
    out_c = rr._render_stage_ff(model, rb, coarse, cfg, "coarse", pts,
                                z_vals, kernels=False)["outputs"]
    z_all = rr.sampling.importance_resample_z(
        z_vals, out_c["weights"], cfg.n_importance, cfg.inv_uniform,
        det=True)
    pts_f = z_all[..., None] * rb["ray_d"][:, None] + rb["ray_o"][:, None]
    ins = rr.stage_inputs(model, rb, fine, cfg, "fine", pts_f,
                          kernels=False)
  return ins_c, ins, pts_f


def _trained_alone(stats, name, st_net, dy_net, ins):
  """K2 and K3 alone on one chunk's stage inputs at trained weights,
  against the f32 module and its bf16 twin (utils/kernel_check.bf16_twin).
  Finite and their -1e9 fills exact, or this raises.  Into ``stats`` per
  kernel and part (colours, the densities that are not fills): the largest
  error of the kernel and of the twin against the f32 module, the largest
  kernel / bar ratio of the bf16-twin bar (kernel_check.forward_errors),
  and the values outside phase 2's bars (which hold at random weights:
  counted, not gated).  For K2 also the error of the twin with ray_diff
  kept in f32, as K2 reads it (the twin rounds it to bf16 before the
  anti-alias pooling weights, which subtract cosines near 1).  Returns
  the parts beyond the bf16-twin bar."""
  from dynibar_tpu_torch.ops import agg
  from dynibar_tpu_torch.utils import kernel_check as kc
  beyond = []
  with torch.no_grad():
    raws = {"K2": (agg.fused_static_aggregator(st_net, *ins["st"]),
                   st_net(*ins["st"]), kc.bf16_twin(st_net, True, ins["st"]),
                   2e-2),
            "K3": (agg.fused_dynamic_aggregator(dy_net, *ins["dy"]),
                   dy_net(*ins["dy"]), kc.bf16_twin(dy_net, False, ins["dy"]),
                   1e-2)}
    st_f32_diff = [a.to(torch.bfloat16) if i == 3 else a     # rgb_feat only
                   for i, a in enumerate(ins["st"])]
    with torch.autocast(st_f32_diff[0].device.type, dtype=torch.bfloat16):
      twin_rd = st_net(*st_f32_diff).float()
  for key, (got, want, twin, atol) in raws.items():
    fill = want[..., 3] <= -1e8
    if not (torch.isfinite(got).all()
            and torch.equal(got[..., 3] <= -1e8, fill)):
      raise AssertionError(f"{key} ({name}): non-finite output, or the -1e9 "
                           "sigma entries differ")
    err = (got - want).abs()
    out = err > atol + 2e-2 * want.abs()
    errors = kc.forward_errors(got, want, twin)
    for part, o in (("colours", out[..., :3]),
                    ("densities", out[..., 3][~fill])):
      ek, eb, bar = errors[part]
      rec = stats.setdefault(f"{key} {part}", [0.0, 0.0, 0.0, 0, 0, 0.0])
      rec[0], rec[1] = max(rec[0], ek), max(rec[1], eb)
      rec[2] = max(rec[2], ek / bar)
      rec[3] += int(o.sum())
      rec[4] += o.numel()
      if key == "K2":
        rec[5] = max(rec[5], kc.forward_errors(twin_rd, want, twin)[part][0])
      if ek > bar:
        beyond.append(f"{key} {part} ({name}): kernel {ek:.4g}, bf16 twin "
                      f"{eb:.4g}, bar {bar:.4g}")
  return beyond


def _trained_report(card, what, stats, beyond):
  """Print ``_trained_alone``'s records; raise on any part beyond the
  bf16-twin bar."""
  print(f"{what}: K2 and K3 alone, largest error against the f32 module "
        f"of the kernel / of its bf16 twin (K2: / of the twin with ray_diff "
        f"in f32), the largest kernel / bar ratio (bar 2 twin + 1e-3), "
        f"values outside phase 2's bar (reported): "
        + "; ".join(f"{k} {ek:.4g} / {eb:.4g}"
                    + (f" / {erd:.4g}" if k.startswith("K2") else "")
                    + f", {r:.3f}, {o} of {n}"
                    for k, (ek, eb, r, o, n, erd) in stats.items())
        + f" [{card}]", flush=True)
  if beyond:
    raise AssertionError(f"{what}: beyond the bf16-twin bar: {beyond}")


def _load_script(name):
  import importlib.util
  path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                      f"{name}.py")
  spec = importlib.util.spec_from_file_location(name, path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _ff_ladder_phase(card, dev, frames=24, steps=100, chunk=1024):
  """Phase 15: scripts/port_ff_convergence.run at 100 + 100 steps (its
  gate reported, not enforced), then the three rungs of
  scripts/port_eval_ff_synthetic on its phase-B snapshot over frame 3's 11
  viewpoints, and K2 / K3 at the trained weights against both twins.
  Returns (the convergence run's launches, the fused rung's per viewpoint
  frame)."""
  import tempfile
  from dynibar_tpu_torch.models.dynibar import BF16_TWIN
  from dynibar_tpu_torch.render import render_rays as rr
  from dynibar_tpu_torch.render.render_image import full_image_ray_batch
  from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
  t_phase = time.perf_counter()
  conv = _load_script("port_ff_convergence")
  ladder = _load_script("port_eval_ff_synthetic")
  with tempfile.TemporaryDirectory() as outdir:
    argv = ["--outdir", outdir, "--frames", str(frames), "--coarse_steps",
            str(steps), "--fine_steps", str(steps), "--eval_every",
            str(steps)]
    log = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(log):    # 100 + 100 steps: not gated
      res = conv.run(conv.parse_args(argv))
    torch.cuda.synchronize()
    conv_launches = _read_counts()
    print(f"FF convergence: {steps} coarse + {steps} fine steps at N_rand "
          f"{res['config']['N_rand']} / {res['config']['N_rand_fine']}, "
          f"{res['config']['hw']}, {frames} frames; s/step "
          f"{ {p: round(v, 4) for p, v in res['s_per_step'].items()} }; "
          f"the fine rise over its phase-B init {res['fine_rise_db']:+.3f} "
          f"dB, over the frozen coarse render "
          f"{res['fine_minus_frozen_coarse_db']:+.3f} dB (printed, not "
          f"gated; the gate run's bar is +5 dB at 1500 + 2500 steps); "
          f"launches { {k: n for k, n in conv_launches.items() if n} } "
          f"[{card}]", flush=True)

    # the three rungs over frame 3's 11 viewpoints
    h, w = res["config"]["hw"]
    root = os.path.join(outdir, f"scene_{frames}x{h}x{w}")
    base = ["--ckpt", os.path.join(outdir, "ckpt_ff_B"), "--root", root,
            "--height", str(h), "--frames", "1"]
    rungs = {}
    for mode in ladder.RUNGS:
      torch.cuda.reset_peak_memory_stats()
      log = io.StringIO()
      _zero_counts()
      with contextlib.redirect_stdout(log):
        rung = ladder.run(ladder.parse_args(base + ["--mode", mode]))
      torch.cuda.synchronize()
      rung["launches"] = _read_counts()
      rung["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
      rungs[mode] = rung
      tables = [rung[r][m] for r in ("full", "dynamic", "static")
                for m in ("psnr", "ssim")]
      if not (np.isfinite(tables).all() and rung["viewpoints"] == 11):
        raise AssertionError(f"ladder {mode}: {rung['viewpoints']} "
                             f"viewpoints, tables {tables}")
      print(f"ladder {mode}: " + ", ".join(
          f"{r} psnr {rung[r]['psnr']:.4f} ssim {rung[r]['ssim']:.4f}"
          for r in ("full", "dynamic", "static"))
            + f"; {rung['s_per_viewpoint']:.4f} s per viewpoint frame, "
            f"{rung['eval_seconds']:.2f} s for 11, peak memory "
            f"{rung['peak_gib']:.2f} GiB [{card}]", flush=True)
    for a, b in (("exact_bf16", "exact_f32"), ("fused_bf16", "exact_f32"),
                 ("fused_bf16", "exact_bf16")):
      print(f"ladder {a} - {b}: " + ", ".join(
          f"{r} {rungs[a][r]['psnr'] - rungs[b][r]['psnr']:+.4f} dB / ssim "
          f"{rungs[a][r]['ssim'] - rungs[b][r]['ssim']:+.5f}"
          for r in ("full", "dynamic", "static")) + f" [{card}]",
            flush=True)

    # 1024-ray chunks of two viewpoints at the trained weights (each
    # view's first, middle and last): the kernels' chunk against the
    # plain path's (rgb within 3e-2, as phases 9 and 14 hold it) and, as
    # recorded, against the bf16 twins' and the twins' against the plain
    # path's; K2 and K3 alone at both stages
    args = ladder.parse_args(base)
    config, model, _ = ladder.load(args)
    cfg = model.cfg
    data = NvidiaSceneData(config, args.scene, height=args.height)
    stats, beyond = {}, []
    worst = {"kernels - plain": 0.0, "kernels - bf16 twins": 0.0,
             "bf16 twins - plain": 0.0}
    for cam_i in (0, 6):
      batch = data.eval_batch(3, cam_i)
      rb = {k: v for k, v in batch.items() if k != "static_src_masks"}
      rb = full_image_ray_batch(rb, rb["camera"], device=dev)
      with torch.no_grad():
        coarse, fine = model.encode_featmaps(rb["src_rgbs"],
                                             rb["static_src_rgbs"])
      for start in (0, h * w // 2 - chunk // 2, h * w - chunk):
        part = {k: (v[start:start + chunk] if k in ("ray_o", "ray_d",
                                                    "uv_grid") else v)
                for k, v in rb.items()}
        name = f"frame 3 cam {cam_i} rays {start}"
        with torch.no_grad():
          ker, twin, plain = (
              rr.render_rays_mv(model, part, coarse, fine, cfg, device=dev,
                                kernels=k) for k in (True, BF16_TWIN, False))
        for stage in ("outputs_coarse_ref", "outputs_fine_ref"):
          rgb = ker[stage]["rgb"]
          if not torch.isfinite(rgb).all() or rgb.shape != (chunk, 3):
            raise AssertionError(f"{name}: {stage} rgb not finite or "
                                 "misshapen")
          errs = dict(zip(worst, (
              float((a[stage]["rgb"] - b[stage]["rgb"]).abs().max())
              for a, b in ((ker, plain), (ker, twin), (twin, plain)))))
          if errs["kernels - plain"] > 3e-2:
            raise AssertionError(f"{name}: {stage} kernels vs plain rgb "
                                 f"{errs}")
          worst = {k: max(v, errs[k]) for k, v in worst.items()}
        ins_c, ins, _ = _ff_stage_inputs(model, cfg, part, coarse, fine)
        for stage, stage_ins in (("coarse", ins_c), ("fine", ins)):
          beyond += _trained_alone(
              stats, f"{name}, {stage}",
              getattr(model, f"net_{stage}_st"),
              getattr(model, f"net_{stage}_dy"), stage_ins)
  # the fused rung launches K1 / K2 / K3 4 / 2 / 2 per chunk (two
  # stages, each a dynamic and a static view set), the others none
  chunks = -(-h * w // ladder.CHUNK)
  per_view = {k: n // 11 for k, n in rungs["fused_bf16"]["launches"].items()}
  want = {k: (4 * chunks if k == "K1" else 2 * chunks
              if k in ("K2", "K3") else 0) for k in per_view}
  if rungs["fused_bf16"]["launches"] != {k: 11 * n
                                         for k, n in want.items()}:
    raise AssertionError(f"ladder fused_bf16 launches "
                         f"{rungs['fused_bf16']['launches']}, want 11 x "
                         f"{want}")
  for mode in ("exact_f32", "exact_bf16"):
    if any(rungs[mode]["launches"].values()):
      raise AssertionError(f"ladder {mode} launched "
                           f"{rungs[mode]['launches']}")
  print(f"ladder fused_bf16 launches per viewpoint frame "
        f"{ {k: n for k, n in per_view.items() if n} } ({chunks} chunks "
        f"of {ladder.CHUNK} rays)", flush=True)
  print(f"ladder at the trained weights, 6 chunks of {chunk} rays of frame "
        f"3's views 0 and 6, both stages, largest rgb difference: "
        + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()) + f" [{card}]",
        flush=True)
  _trained_report(card, "ladder at the trained weights, both stages", stats,
                  beyond)
  print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
  return conv_launches, per_view


def _resize_to_float(img, oh: int, ow: int) -> np.ndarray:
  """runtime/image_loader.cc's ResizeToFloat in numpy float32, operation
  for operation: uint8 [h, w(, c)] -> [oh, ow, 3] in [0, 1], gray (and
  gray+alpha) as its gray three times, alpha dropped, bilinear with
  half-pixel centres and clamped corners when the size changes."""
  img = np.asarray(img)
  if img.ndim == 2:
    img = img[..., None]
  src = (img[..., [0, 0, 0]] if img.shape[2] < 3 else img[..., :3]).astype(
      np.float32)
  h, w = src.shape[:2]
  one, half = np.float32(1.0), np.float32(0.5)
  inv255 = one / np.float32(255.0)
  if (oh, ow) == (h, w):
    return src * inv255

  def axis(n_out, n_in):
    scale = np.float32(n_in) / np.float32(n_out)
    f = (np.arange(n_out, dtype=np.float32) + half) * scale - half
    i0 = np.where(f < 0, 0, f.astype(np.int64))   # truncation, as C casts
    i1 = np.minimum(i0 + 1, n_in - 1)
    wt = np.maximum(f - i0.astype(np.float32), np.float32(0.0))
    return i0, i1, wt

  y0, y1, wy = axis(oh, h)
  x0, x1, wx = axis(ow, w)
  wy, wx = wy[:, None, None], wx[None, :, None]
  v00, v01 = src[y0][:, x0], src[y0][:, x1]
  v10, v11 = src[y1][:, x0], src[y1][:, x1]
  v = ((one - wy) * ((one - wx) * v00 + wx * v01)
       + wy * ((one - wx) * v10 + wx * v11))
  return v * inv255


def _decode_frames(root: str, frames: int, h: int, w: int):
  """`frames` frames of a moving blob over texture with sensor-like noise
  (sigma 6 of 255, seeded), written as PNG (data/png.py) and as JPEG
  (data/jpeg.py's writer: quality 75, 4:2:0; the card's machine has no
  PIL); returns the two lists of paths."""
  from dynibar_tpu_torch.data import jpeg, png
  rng = np.random.RandomState(SEED)
  yy, xx = np.mgrid[0:h, 0:w]
  bg = np.stack([0.5 + 0.4 * np.sin(xx / 7.0), 0.5 + 0.4 * np.cos(yy / 5.0),
                 0.5 + 0.4 * np.sin((xx + yy) / 9.0)], -1)
  pngs, jpegs = [], []
  for i in range(frames):
    blob = np.exp(-((xx - w * (0.3 + 0.4 * i / frames)) ** 2
                    + (yy - h / 2) ** 2) / 400.0)
    img = np.clip(bg + blob[..., None] * np.array([0.5, -0.2, 0.1]), 0, 1)
    img = img * 255 + rng.normal(0.0, 6.0, img.shape)
    img8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
    pngs.append(os.path.join(root, f"{i:05d}.png"))
    jpegs.append(os.path.join(root, f"{i:05d}.jpg"))
    png.write(pngs[-1], img8)
    jpeg.write(jpegs[-1], img8)
  return pngs, jpegs


def _decode_ms(fn, files, threads):
  """(results, ms per file) of fn over files on a pool of `threads`."""
  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(threads) as pool:
    out = list(pool.map(fn, files))
  return out, (time.perf_counter() - t0) / len(files) * 1e3


def _decode_phase(card, dev, root, frames=48, h=288, w=512):
  """Phase 16: the host decoder (csrc/image_loader.cc) and flow IO on the
  card's machine, while nvcc builds the kernels (no hand kernel here):
  build the library; write a 48-frame 288x512 scene as PNG and JPEG; every
  frame from read_image equal, byte for byte, to decoder="numpy"; the
  batch entry at 4 threads equal to the single-file path broadcast and
  scaled; a 144x256 batch finite, in [0, 1] and equal to
  _resize_to_float; a missing file raising IOError naming it; warp_flow on
  the card equal to warp_flow on the CPU within 1e-6 at 288x512 with a
  fractional flow.  Prints the decode ms per frame of each decoder and
  format at 1 and 4 threads (contended: nvcc runs beside it) and the
  phase's seconds."""
  from dynibar_tpu_torch.data import flow_io, llff, native_loader
  from dynibar_tpu_torch.ops import build
  t_phase = time.perf_counter()
  secs = build.build_host("image_loader")
  print(f"host decoder build: {secs:.1f} s ({build.HOST_FLAGS})",
        flush=True)
  t0 = time.perf_counter()
  pngs, jpegs = _decode_frames(root, frames, h, w)
  print(f"decode: wrote {frames} {h}x{w} frames as PNG and JPEG in "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  cores = len(os.sched_getaffinity(0))
  inv255 = np.float32(1.0) / np.float32(255.0)
  report = {"cores": cores}
  for kind, files in (("png", pngs), ("jpeg", jpegs)):
    decoded = {}
    for decoder in llff.DECODERS:
      for threads in (1, 4):
        out, ms = _decode_ms(
            lambda p, d=decoder: llff.read_image(p, decoder=d), files,
            threads)
        report[f"{kind}_{decoder}_{threads}t_ms"] = ms
        decoded.setdefault(decoder, out)
    for i, (a, b) in enumerate(zip(decoded["native"], decoded["numpy"])):
      if a.dtype != np.uint8 or a.shape != (h, w, 3) or not np.array_equal(
          a, b):
        raise AssertionError(f"decode: {files[i]} differs from the numpy "
                             f"decoder ({a.dtype} {a.shape})")
    want = np.stack(decoded["native"]).astype(np.float32) * inv255
    for threads in (1, 4):
      loader = native_loader.NativeImageLoader(threads)
      t0 = time.perf_counter()
      batch = loader.decode(files)
      report[f"{kind}_batch_{threads}t_ms"] = ((time.perf_counter() - t0)
                                               / frames * 1e3)
      if not np.array_equal(batch, want):
        raise AssertionError(f"decode: the {kind} batch at {threads} "
                             "threads differs from the single-file path")
      if threads == 4:
        small = loader.decode(files, h // 2, w // 2)
      loader.close()
    ref = np.stack([_resize_to_float(img, h // 2, w // 2)
                    for img in decoded["native"]])
    if not (np.isfinite(small).all() and small.min() >= 0
            and small.max() <= 1 and np.array_equal(small, ref)):
      raise AssertionError(f"decode: the resized {kind} batch vs numpy: "
                           f"max abs {float(np.abs(small - ref).max())}")
    print(f"decode {kind}: ms per {h}x{w} frame, numpy "
          f"{report[kind + '_numpy_1t_ms']:.2f} / "
          f"{report[kind + '_numpy_4t_ms']:.2f}, native "
          f"{report[kind + '_native_1t_ms']:.2f} / "
          f"{report[kind + '_native_4t_ms']:.2f} on 1 / 4 threads, native "
          f"batch {report[kind + '_batch_1t_ms']:.2f} / "
          f"{report[kind + '_batch_4t_ms']:.2f} on 1 / 4 C++ threads "
          f"({cores} cores, nvcc running beside it) [{card}]", flush=True)
  missing = os.path.join(root, "no_such_frame.png")
  try:
    native_loader.NativeImageLoader(1).decode([pngs[0], missing], 8, 8)
  except IOError as exc:
    if missing not in str(exc):
      raise AssertionError(f"decode: the error names no file: {exc}")
  else:
    raise AssertionError("decode: a missing file raised nothing")
  rng = np.random.RandomState(SEED + 16)
  img = torch.from_numpy(want[0])
  flow = torch.from_numpy((rng.randn(h, w, 2) * 6).astype(np.float32))
  on_cpu = flow_io.warp_flow(img, flow)
  on_card = flow_io.warp_flow(img.to(dev), flow.to(dev)).cpu()
  err = float((on_card - on_cpu).abs().max())
  if not (on_card.shape == (h, w, 3) and err <= 1e-6):
    raise AssertionError(f"warp_flow: card vs CPU {err}")
  seconds = time.perf_counter() - t_phase
  print(f"warp_flow {h}x{w}, fractional flow: card vs CPU max abs "
        f"{err:.3g}; phase 16: {seconds:.1f} s", flush=True)
  report["warp_flow_max_abs_err"] = err
  report["seconds"] = seconds
  return report


def _footprints(card):
  """Each aggregator kernel's footprint; the forward trunk keeps two
  blocks per SM at every view count of the main paths (FF 7 and 11, mono
  9, 10 and 14)."""
  from dynibar_tpu_torch.ops import agg
  occ = {v: agg.occupancy(v) for v in (7, 9, 10, 11, 14)}
  for v, o in occ.items():
    print(f"footprint at V={v} (bytes, blocks/SM): {o} [{card}]",
          flush=True)
  for v in (11, 14):
    if occ[v]["K2 trunk"][1] != 2:
      raise AssertionError(f"K2 trunk: {occ[v]['K2 trunk']} at V={v}")
  for v in (7, 9, 10):
    if occ[v]["K3 trunk"][1] != 2:
      raise AssertionError(f"K3 trunk: {occ[v]['K3 trunk']} at V={v}")


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
  t_start = time.perf_counter()

  # ---- 0: the card --------------------------------------------------------
  card = _card()
  dev = resolve_device(None)          # also turns TF32 off
  print(f"card: {card}", flush=True)

  # ---- 1: build -----------------------------------------------------------
  # K4s's library (dynamic_agg_bwd1) takes twice as long as any other: it
  # builds beside the others and on through phases 14, 15, 2 and 2b,
  # which launch no K4s, until its first launch in 2b
  t_build = time.perf_counter()
  pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
  k4s_build = pool.submit(build.build, [K4S_LIB])
  kernels_build = pool.submit(build.build, [
      n for n in build.KERNEL_SOURCES if n != K4S_LIB])

  # ---- 16: the host decoder and flow IO, while nvcc builds -------------
  import tempfile
  with tempfile.TemporaryDirectory() as decode_root:
    _decode_phase(card, dev, decode_root)
  secs = kernels_build.result()
  print(f"build: {time.perf_counter() - t_build:.1f} s "
        f"({ {k: round(v, 1) for k, v in secs.items()} }; {K4S_LIB} goes "
        f"on)", flush=True)

  # ---- 14: the mono convergence run, compressed schedule ----------------
  conv_launches = _mono_convergence_phase(card, dev)
  torch.cuda.empty_cache()

  # ---- 15: the FF ladder at trained weights (no K4s either) --------------
  ff_conv_launches, ladder_launches = _ff_ladder_phase(card, dev)
  torch.cuda.empty_cache()

  h, w, chunk = 288, 512, 1024
  cfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                       num_views_anchor=0, num_views_static=11, num_basis=6,
                       inv_uniform=True, compute_dtype="bfloat16")
  model = FFModel(cfg, num_frames=48, seed=SEED)
  rb = to_device(synthetic_ff_batch(cfg, n_rays=chunk, h=h, w=w,
                                    num_frames=48, seed=SEED,
                                    scanline=True), dev)
  with torch.no_grad():
    coarse, fine = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])

  # ---- 2: each kernel vs its plain twin at the main path's shapes ---------
  ins_c, ins, pts_f = _ff_stage_inputs(model, cfg, rb, coarse, fine)
  results = {}

  # K1 at the fine stage's static views (11 views, 1024 x 128 points,
  # bf16): 288x512 RGB and 72x128 features
  with torch.no_grad():
    pix, _ = rr.proj.project_points(
        pts_f[None].expand((11,) + pts_f.shape), rb["static_src_cameras"])
    grid = (2.0 * pix / torch.tensor([w - 1.0, h - 1.0], device=dev)
            - 1.0).contiguous()
    results["K1"] = _sampler_report(
        card, rb["static_src_rgbs"].to(torch.bfloat16).contiguous(),
        fine[2].to(torch.bfloat16).contiguous(), grid)
  del pix, grid

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
      bound, by = _forward_bound(static, net, args)
      results[key] = dict(
          name=("fused_static_aggregator" if static
                else "fused_dynamic_aggregator"), route="cuda",
          source=FWD_SOURCE,
          replaces=("dynibar_tpu/ops/pallas_agg.py:225" if static
                    else "dynibar_tpu/ops/pallas_agg.py:325"),
          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
          bound_by=by, library_ms=None)
  fwd_shapes = {"K2": {}, "K3": {}}
  for key, static, net, args in (("K2", True, model.net_fine_st, ins["st"]),
                                 ("K3", False, model.net_fine_dy, ins["dy"])):
    r, s, v = args[3 if static else 1].shape[:3]
    label = f"FF eval fine R={r} S={s} V={v}"
    fwd_shapes[key][label] = _forward_report(card, label, static, net, args)
  for key, res in results.items():
    print(f"{key} {res['name']}: {res['ms']:.3f} ms "
          f"(plain {res['plain_ms']:.3f} ms, library {res['library_ms']}, "
          f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}), "
          f"max abs err {res['max_abs_err']:.3g} [{card}]", flush=True)
  results["K2"]["mask_rgb0_max_abs_err"] = _mask_rgb0_check(
      dev, (model.net_coarse_st, model.net_fine_st), (ins_c["st"], ins["st"]))

  # ---- 2b: the training kernels vs their twins (fine stage, N_rand) ------
  # the train step's fine-stage shapes: N_rand rays at once through the
  # kernels; the twins in slices of kc.TWIN_RAYS rays (weight gradients
  # summed over the slices), which hold the same function at the memory of
  # one slice
  from dynibar_tpu_torch.utils import kernel_check as kc
  n_rand = 3072
  rb_t = to_device(synthetic_ff_batch(cfg, n_rays=n_rand, h=h, w=w,
                                      num_frames=48, seed=SEED + 1), dev)
  with torch.no_grad():
    maps_t = model.encode_featmaps(rb_t["src_rgbs"],
                                   rb_t["static_src_rgbs"])
  ins_t = _ff_stage_inputs(model, cfg, rb_t, *maps_t)[1]
  del rb_t, maps_t
  g_cot = torch.Generator(device=dev).manual_seed(SEED + 1)
  st_args, dy_args = ins_t["st"], ins_t["dy"]
  dy6_args = list(dy_args)                 # the anchor pass: 6 views
  dy6_args[1] = dy_args[1][:, :, :6].contiguous()
  dy6_args[3] = dy_args[3][:, :, :6].contiguous()
  train_results, single_ff = {}, {}
  for static, net, args in ((True, model.net_fine_st, st_args),
                            (False, model.net_fine_dy, dy_args),
                            (False, model.net_fine_dy, dy6_args)):
    r, s, v = args[3 if static else 1].shape[:3]
    label = f"FF step R={r} S={s} V={v}"
    fwd_shapes["K2" if static else "K3"][label] = _forward_report(
        card, label, static, net, args)
  for label, static, net, args in (
      ("static V=11", True, model.net_fine_st, st_args),
      ("dynamic V=7", False, model.net_fine_dy, dy_args),
      ("dynamic V=6", False, model.net_fine_dy, dy6_args)):
    cot = torch.randn(*args[0].shape[:2], 4, generator=g_cot, device=dev)
    res = _check_training_kernels(card, label, static, net, args, cot)
    if label != "dynamic V=6":
      train_results.update(res)
    if not static:                  # the same shape on the "pallas" route
      if k4s_build is not None:
        secs.update(k4s_build.result())
        pool.shutdown()
        k4s_build = None
        print(f"build: {K4S_LIB} done "
              f"{time.perf_counter() - t_build:.1f} s after the build began "
              f"({secs[K4S_LIB]:.1f} s of nvcc)", flush=True)
        _footprints(card)
      res = _check_single_kernels(card, label, net, args, cot)
      if label == "dynamic V=7":
        single_ff = res
  # route "pallas" at a sample count that is not a multiple of 64
  args48 = [a if a.dim() == 2 else a[:, :48].contiguous() for a in dy_args]
  cot48 = torch.randn(n_rand, 48, 4, generator=g_cot, device=dev)
  k3p_err, _, vs_split, _ = _single_correctness(
      "dynamic V=7 S=48", model.net_fine_dy, args48, cot48)
  print(f"dynamic V=7 S=48: K3p max abs err {k3p_err:.3g}; K4s within its "
        f"bars; largest relative difference from K4a+K4b "
        f"{max(vs_split.values()):.3g} [{card}]", flush=True)
  del ins_t, st_args, dy_args, dy6_args, args, res, args48, cot48
  torch.cuda.empty_cache()

  # ---- 3: one chunk through the main path ---------------------------------
  _zero_counts()
  ret = rr.render_rays_mv(model, rb, coarse, fine, cfg)
  torch.cuda.synchronize()
  launches = _read_counts()
  if launches != dict({k: 0 for k in launches}, K1=4, K2=2, K3=2):
    raise AssertionError(f"main-path launches per chunk {launches}, "
                         "want 4/2/2")
  launches = {k: launches[k] for k in ("K1", "K2", "K3")}
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

  # ---- 5: the fine-stage train step at N_rand 3072 -----------------------
  from dynibar_tpu_torch.config import TrainSettings
  from dynibar_tpu_torch.train import losses as ff_losses
  from dynibar_tpu_torch.train import trainer
  del model, rb, frame_rb, ins, ins_c, coarse, fine, out, ret, plain, one_frame
  torch.cuda.empty_cache()
  tr_cfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                          num_views_anchor=6, num_views_static=11,
                          num_basis=6, inv_uniform=True,
                          compute_dtype="bfloat16")
  t_cfg = TrainSettings()
  weights = ff_losses.schedule_weights(t_cfg, 0)
  tmodel = FFModel(tr_cfg, num_frames=48, seed=SEED).train_fine()
  opt = trainer.make_ff_optimizer(tmodel, t_cfg)
  batch = to_device(synthetic_ff_batch(tr_cfg, n_rays=n_rand, h=h, w=w,
                                       num_frames=48, seed=SEED), dev)

  def step(b, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    return trainer.ff_train_step(tmodel, opt, b, weights, tr_cfg, t_cfg,
                                 generator=gen)

  _zero_counts()
  t0 = time.perf_counter()
  loss, metrics, _ = step(batch, SEED)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - t0
  step_launches = _read_counts()
  if step_launches != TRAIN_LAUNCHES:
    raise AssertionError(f"train-step launches {step_launches}, want "
                         f"{TRAIN_LAUNCHES}")
  if not all(bool(torch.isfinite(v)) for v in metrics.values()):
    raise AssertionError(f"train step: non-finite metrics {metrics}")
  print(f"train step launches: {step_launches}; first step {first_s:.2f} s, "
        f"loss {float(loss):.5f}, psnr {float(metrics['psnr']):.3f}, "
        f"grad_norm {float(metrics['grad_norm']):.4g}", flush=True)

  # kernel vs plain gradients of the second step's loss on the step's
  # batch, from the same weights and generator seed (after one update, so
  # the motion coefficients, zero at init, pass a gradient to the
  # trajectory basis).  The plain run's fine aggregators run in
  # checkpointed ray slices (kc.sliced_twin): the same loss over all
  # N_rand rays, with the twins' activations of one slice
  grads = {}
  for kernels in (True, False):
    tmodel.zero_grad(set_to_none=True)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    with contextlib.ExitStack() as stack:
      if not kernels:
        stack.enter_context(kc.sliced_twin(tmodel.net_fine_st))
        stack.enter_context(kc.sliced_twin(tmodel.net_fine_dy))
      l, _ = trainer.ff_loss(tmodel, batch, weights, tr_cfg, kernels=kernels,
                             generator=gen)
      l.backward()
    grads[kernels] = (float(l.detach()), {
        k: torch.cat([p.grad.reshape(-1) for p in ps])
        for k, ps in tmodel.param_groups().items()})
    del l
  tmodel.zero_grad(set_to_none=True)
  loss_rel = abs(grads[True][0] - grads[False][0]) / abs(grads[False][0])
  group_rel = {k: float((g - grads[False][1][k]).norm()
                        / grads[False][1][k].norm())
               for k, g in grads[True][1].items()}
  print(f"train step kernel vs plain (N_rand {n_rand}): loss "
        f"{grads[True][0]:.6f} vs {grads[False][0]:.6f} (rel "
        f"{loss_rel:.2e}); gradient rel-norm per group "
        f"{({k: round(v, 5) for k, v in group_rel.items()})}", flush=True)
  if not (loss_rel <= 1e-2 and all(v <= 5e-2 for v in group_rel.values())):
    raise AssertionError("train step: kernel and plain gradients disagree")
  del grads
  torch.cuda.empty_cache()

  for i in range(2):                                      # warm-up
    step(batch, SEED + 10 + i)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  held_gib = torch.cuda.memory_allocated() / 2 ** 30   # weights, batch, Adam
  secs_step = []
  for i in range(5):
    t0 = time.perf_counter()
    loss, metrics, _ = step(batch, SEED + 20 + i)
    torch.cuda.synchronize()
    secs_step.append(time.perf_counter() - t0)
  peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
  print(f"train step: {np.mean(secs_step):.4f} s/step at N_rand {n_rand}, "
        f"mean of {len(secs_step)} after 2 warm-ups (min "
        f"{min(secs_step):.4f}, max {max(secs_step):.4f}), peak memory "
        f"{peak_gib:.2f} GiB ({held_gib:.2f} GiB held before the steps) "
        f"[{card}]", flush=True)

  curve = []
  for _ in range(10):                   # one batch, one sample placement
    loss, _, _ = step(batch, SEED + 30)
    curve.append(float(loss))
  print(f"train loss over 10 steps on one batch: "
        f"{[round(x, 5) for x in curve]}", flush=True)
  if not (np.isfinite(curve).all() and curve[-1] < curve[0]):
    raise AssertionError("train step: the loss did not fall")
  del tmodel, opt, batch, step, loss, metrics
  torch.cuda.empty_cache()

  # ---- 6: the mono model --------------------------------------------------
  mono_results, mono_launches, mono_stats, mono_fwd = _mono_phases(
      card, dev, h, w, n_rand, t_cfg)

  with tempfile.TemporaryDirectory() as cli_root:
    # ---- 8: the training CLI from an on-disk scene ------------------------
    cli_launches, snapshot = _cli_phase(card, dev, h, w, cli_root)

    # ---- 9: the Nvidia eval CLI from an on-disk scene ---------------------
    eval_launches = _eval_phase(card, dev, h, w)

    # ---- 10: the served mono frame over phase 8's scene and snapshot -----
    serve_launches, aa0_err = _serve_phase(card, dev, h, w, cli_root,
                                           snapshot)

    # ---- 13: the mesh on the one card, over phase 8's scene and snapshot --
    mesh_launches = _mesh_phase(card, h, w, cli_root, snapshot, n_rand)

  # ---- 11: the FF coarse stage's training and the chain from disk -------
  t_phase = time.perf_counter()
  c_cfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                         num_views_anchor=6, num_views_static=11,
                         num_basis=6, inv_uniform=True,
                         compute_dtype="bfloat16")
  coarse_results = _coarse_kernels(card, dev, h, w, n_rand, c_cfg,
                                   FFModel(c_cfg, num_frames=48, seed=SEED))
  coarse_launches, coarse_stats = _coarse_step(card, dev, h, w, n_rand,
                                               c_cfg, t_cfg)
  chain = _coarse_chain(card, dev, h, w, n_rand)
  print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)

  # ---- 12: preprocess a scene on the card, then train on it -------------
  pre_launches = _preprocess_phase(card, dev, h, w, n_rand=n_rand)
  print(f"phases done in {time.perf_counter() - t_start:.1f} s", flush=True)

  # ---- 7: result ----------------------------------------------------------
  # K1-K3 at the FF eval chunk and the other training kernels at the FF
  # step's shapes, as earlier slices reported them, with their launches on
  # that path; K5c/K5d at the mono step's (their only path: the
  # pallas_split3 route).  Each training kernel also carries its time and
  # launches at the mono shape.
  kernels = []
  for key in ("K1", "K2", "K3"):
    res = dict(results[key])
    res["launches"] = launches[key]
    res["eval_launches"] = eval_launches[key]
    res["serve_launches"] = serve_launches[key]
    if key == "K2":
      res["anti_alias0_max_abs_err"] = aa0_err
    if key != "K1":
      res["forward_shapes"] = dict(fwd_shapes[key], **mono_fwd[key])
    res["preprocess_cli_launches"] = pre_launches[key]
    res["mesh_launches"] = mesh_launches[key]
    res["mono_convergence_launches"] = conv_launches[key]
    res["ff_convergence_launches"] = ff_conv_launches[key]
    res["ladder_launches"] = ladder_launches[key]
    kernels.append(res)
  for key in ("K2r", "K5a", "K5b", "K3r", "K4a", "K4b", "K5c", "K5d"):
    res = dict(train_results[key] if key in train_results
               else mono_results[key])
    res["launches"] = (step_launches[key] if key in train_results
                       else mono_launches["pallas_split3"][key])
    res["mono_ms"] = mono_results[key]["ms"]
    res["mono_bound_ms"] = mono_results[key]["bound_ms"]
    res["mono_launches"] = {route: n[key]
                            for route, n in mono_launches.items()}
    _add_coarse(res, key, coarse_results, coarse_launches, chain)
    res["preprocess_cli_launches"] = pre_launches[key]
    res["mesh_launches"] = mesh_launches[key]
    res["mono_convergence_launches"] = conv_launches[key]
    res["ff_convergence_launches"] = ff_conv_launches[key]
    kernels.append(res)
  # K3p/K4s at the mono step's shapes (V = 9), their launches on the mono
  # step's "pallas" route; also their times at the FF step's (V = 7, S =
  # 128) and K4s's at V = 10, and their launches in the CLI's first run
  for key in ("K3p", "K4s"):
    res = dict(mono_results[key])
    res["launches"] = mono_launches["pallas"][key]
    res["ff_ms"] = single_ff[key]["ms"]
    res["ff_bound_ms"] = single_ff[key]["bound_ms"]
    res["mono_launches"] = {route: n[key]
                            for route, n in mono_launches.items()}
    res["cli_launches"] = cli_launches[key]
    if key == "K4s":
      res["ms_v10"] = mono_results["K4s V=10"]["ms"]
    _add_coarse(res, key, coarse_results, coarse_launches, chain)
    res["preprocess_cli_launches"] = pre_launches[key]
    res["mesh_launches"] = mesh_launches[key]
    res["mono_convergence_launches"] = conv_launches[key]
    res["ff_convergence_launches"] = ff_conv_launches[key]
    kernels.append(res)
  print(f"mono step per route: {mono_stats} [{card}]", flush=True)
  print(f"FF coarse step per route: {coarse_stats}; chain: "
        f"{ {k: v for k, v in chain.items() if k != 'cli_launches'} } "
        f"[{card}]", flush=True)
  print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
        flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(card, flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
