"""Monocular convergence run of the PyTorch port: overfit the mono model on
the analytic scene and gate on held-out novel views.

The port's counterpart of ``scripts/convergence_run.py``.  It writes
``ConsistentScene.write`` (a monocular video of a multi-view-consistent
dynamic scene, with exact ground truth at any pose and time) and trains
the mono model as ``cli/train`` does: the static bootstrap for
``init_decay_epoch // 2`` epochs, then the full loss under
``schedule_weights`` per epoch, each batch drawn under its epoch's
curriculum (``cli/train.curriculum_sampler``).  Every divisor transition
of the schedule goes into ``schedule_events`` with its weights, and the
one-shot ``model_no-vv`` snapshot is written once, at the start of epoch
``init_decay_epoch * 5``.  Step ``s`` falls in epoch ``(s - 1) //
frames``, as the CLI counts whole epochs from its first step.

Gate (the JAX script's): the minimum over the two held-out cameras
(``eval/held_out.mono_eval_views``) of the crop-3% PSNR rise over init
must reach ``--gate_db``; a failed gate exits 1.  Every eval writes a
snapshot of the model and optimizer, the renders and
``<outdir>/mono_convergence_<tag>.json`` (a partial record until the end)
and prints the mean s/step (a host sync per step); ``--resume``
continues from the newest snapshot with the earlier curve and schedule
events merged.  Everything goes under ``--outdir``.

    python scripts/port_mono_convergence.py --clip 1 --init_decay_epoch 10 \\
        --steps 3000 --frames 24 --tag h100_3ksched --outdir build/monoconv
    python scripts/port_mono_convergence.py --quick --outdir DIR     # CPU

The production configuration (N_rand 3072, 64 samples, 7 source and 3
virtual views, 6 bases, bf16) runs on the card on the default backward
routes; ``--route_dy`` / ``--route_st`` / ``--compute_dtype`` change
them.  ``--quick`` runs a tiny configuration on the CPU (the plain twins,
f32; 10 frames of 40x60 unless given, at most 120 steps of 128 rays) and
reports the train view's rise and the loss drop within the full phase
without enforcing the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TERM_KEYS = ("rgb_loss", "disp_loss", "flow_loss", "cycle_loss", "reg_loss",
             "entropy_loss", "distortion_loss", "static_loss")


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=3000)
  ap.add_argument("--eval_every", type=int, default=250)
  ap.add_argument("--frames", type=int, default=None,
                  help="default 24 (10 with --quick)")
  ap.add_argument("--height", type=int, default=None,
                  help="default 96 (40 with --quick)")
  ap.add_argument("--width", type=int, default=None,
                  help="default 144 (60 with --quick)")
  ap.add_argument("--n_rand", type=int, default=None,
                  help="default 3072 (128 with --quick)")
  ap.add_argument("--init_decay_epoch", type=int, default=None,
                  help="default 40 (2 with --quick)")
  ap.add_argument("--outdir", type=str, required=True)
  ap.add_argument("--tag", type=str, default="default")
  ap.add_argument("--quick", action="store_true",
                  help="tiny CPU run (plain twins, f32); the gate is "
                       "reported, not enforced")
  ap.add_argument("--gate_db", type=float, default=8.0,
                  help="required novel-view PSNR rise over init (dB)")
  ap.add_argument("--clip", type=float, default=0.0,
                  help="global-norm gradient clip (0 = off, like the "
                       "reference)")
  ap.add_argument("--resume", action="store_true",
                  help="continue from the newest snapshot in "
                       "<outdir>/ckpt_<tag>")
  ap.add_argument("--route_dy", type=str, default="pallas_split",
                  help="the dynamic aggregator's backward: pallas_split "
                       "or pallas")
  ap.add_argument("--route_st", type=str, default="pallas_split",
                  help="the static aggregator's backward: pallas_split "
                       "or pallas_split3")
  ap.add_argument("--compute_dtype", type=str, default=None,
                  help="sampling dtype: default bfloat16 (float32 with "
                       "--quick)")
  ap.add_argument("--device", type=str, default=None,
                  help="'cpu' for the plain path; default the CUDA card "
                       "(the CPU with --quick)")
  return ap.parse_args(argv)


def build(args):
  """(scene, config, data); writes the scene unless it is there."""
  from dynibar_tpu_torch.config import DynibarConfig
  from dynibar_tpu_torch.data.monocular import MonocularSceneData
  from dynibar_tpu_torch.data.synthetic_scene import ConsistentScene

  for key, full, quick in (("frames", 24, 10), ("height", 96, 40),
                           ("width", 144, 60), ("n_rand", 3072, 128),
                           ("init_decay_epoch", 40, 2),
                           ("compute_dtype", "bfloat16", "float32")):
    if getattr(args, key) is None:
      setattr(args, key, quick if args.quick else full)
  if args.quick:
    args.steps = min(args.steps, 120)
    args.eval_every = min(args.eval_every, 60)
  scene = ConsistentScene(num_frames=args.frames, height=args.height,
                          width=args.width)
  root = os.path.join(args.outdir,
                      f"scene_{args.frames}x{args.height}x{args.width}")
  name = "consistent"
  if not os.path.exists(os.path.join(root, name, "dense",
                                     "poses_bounds_cvd.npy")):
    os.makedirs(root, exist_ok=True)
    scene.write(root, name)
    print(f"wrote scene to {root}", flush=True)

  common = dict(
      folder_path=root, train_scenes=[name], training_height=args.height,
      N_rand=args.n_rand, N_importance=0,
      init_decay_epoch=args.init_decay_epoch, clip_grad_norm=args.clip,
      compute_dtype=args.compute_dtype, fused_bwd_impl=args.route_dy,
      fused_st_bwd_impl=args.route_st, workers=2)
  if args.quick:
    config = DynibarConfig(N_samples=16, num_source_views=4, num_vv=2,
                           num_basis=4, max_range=8, chunk_size=1024,
                           i_print=10, **common)
  else:
    config = DynibarConfig(N_samples=64, num_source_views=7, num_vv=3,
                           num_basis=6, max_range=24, chunk_size=4608,
                           i_print=50, **common)
  data = MonocularSceneData(config, name)
  config.num_frames = data.num_frames
  config.lrate_decay_steps = config.num_frames * config.init_decay_epoch
  return scene, config, data


def gate(curve, losses, gate_db: float, quick: bool) -> dict:
  """The gate's figures from the eval curve (init first, final last) and
  a run of step losses: the minimum crop-3% rise over the novel views,
  the train view's rise, the loss drop (the median of the losses' first
  quarter less that of their last) and whether the gate passed: the
  novel rise against ``gate_db`` or, with ``quick``, the train view's
  rise with a falling loss."""
  first, last = curve[0], curve[-1]
  novel = [k for k in last if k.startswith("psnr_novel")
           and k.endswith("_crop3")]
  novel_rise = min(last[k] - first[k] for k in novel)
  train_rise = (last["psnr_train_view_crop3"]
                - first["psnr_train_view_crop3"])
  loss_drop = None
  if losses:
    q = max(len(losses) // 4, 1)
    loss_drop = float(np.median(losses[:q]) - np.median(losses[-q:]))
  if quick:
    passed = train_rise >= gate_db and loss_drop is not None and loss_drop > 0
  else:
    passed = novel_rise >= gate_db
  return {"novel_psnr_rise_db": round(float(novel_rise), 3),
          "train_view_rise_db": round(float(train_rise), 3),
          "loss_drop": loss_drop, "gate_passed": bool(passed)}


def enforce_gate(result: dict, quick: bool) -> None:
  """Exit 1 on a failed gate, unless ``quick``."""
  if result["gate_passed"] or quick:
    return
  print(f"GATE FAILED: novel-view PSNR rise {result['novel_psnr_rise_db']} "
        f"dB < {result['gate_db']} dB", file=sys.stderr)
  sys.exit(1)


def _round(curve):
  return [{k: round(float(v), 4) for k, v in r.items()} for r in curve]


def run(args) -> dict:
  """The run of ``args`` (``parse_args``): returns the result that it
  writes to the JSON; the gate is reported, not enforced."""
  os.makedirs(args.outdir, exist_ok=True)
  from dynibar_tpu_torch.cli.train import NO_VV, curriculum_sampler
  from dynibar_tpu_torch.config import INIT_SEED, STEP_SEED
  from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
  from dynibar_tpu_torch.eval.held_out import eval_mono, mono_eval_views
  from dynibar_tpu_torch.models.dynibar import MonoModel
  from dynibar_tpu_torch.train.losses import schedule_weights
  from dynibar_tpu_torch.train.trainer import (make_mono_optimizer,
                                               mono_train_step)
  from dynibar_tpu_torch.utils import checkpoints as ckpt_lib
  from dynibar_tpu_torch.utils.device import resolve_device

  dev = resolve_device("cpu" if args.quick else args.device)
  scene, config, data = build(args)
  cfg = config.render_settings("mono")
  t_cfg = config.train_settings()
  frames = data.num_frames
  model = MonoModel(cfg, num_frames=frames, device=dev,
                    seed=INIT_SEED).train_all()
  opt = make_mono_optimizer(model, t_cfg)
  ckpt_dir = os.path.join(args.outdir, f"ckpt_{args.tag}")
  out_path = os.path.join(args.outdir, f"mono_convergence_{args.tag}.json")
  imgdir = os.path.join(args.outdir, f"renders_{args.tag}")
  os.makedirs(imgdir, exist_ok=True)
  card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

  start_step, curve, schedule_events = 0, [], []
  latest = ckpt_lib.latest_checkpoint(ckpt_dir) if args.resume else None
  if latest is not None:
    payload = ckpt_lib.load_checkpoint(latest, map_location=dev)
    model.load_state_dict(payload["model"])
    opt.load_state_dict(payload["optimizer"])
    start_step = int(payload["step"])
    print(f"resumed from {latest} at step {start_step}", flush=True)
    if os.path.exists(out_path):
      # the earlier curve, so the rise over init spans the whole run
      with open(out_path) as fh:
        prev = json.load(fh)
      curve = [r for r in prev.get("curve", [])
               if r.get("step", 0) <= start_step]
      schedule_events = [e for e in prev.get("schedule_events", [])
                         if e["step"] <= start_step]
      print(f"merged {len(curve)} prior eval points from {out_path}",
            flush=True)
  print(f"[{args.tag}] device={card} frames={frames} {scene.h}x{scene.w} "
        f"N_rand={config.N_rand} steps={args.steps} routes="
        f"{cfg.fused_bwd_impl}/{cfg.fused_st_bwd_impl} "
        f"{cfg.compute_dtype}", flush=True)

  views = mono_eval_views(scene)

  def evaluate(step):
    rec = eval_mono(model, data, scene, cfg, config.chunk_size, views,
                    outdir=imgdir, step=step)
    rec["step"] = step
    return rec

  if not curve:
    curve.append(evaluate(start_step))
    print("init:", {k: round(v, 2) for k, v in curve[0].items()},
          flush=True)

  if dev.type == "cuda":
    torch.cuda.reset_peak_memory_stats(dev)
  t_run = time.perf_counter()
  gen = torch.Generator(dev).manual_seed(STEP_SEED + start_step)
  n_bootstrap_epochs = config.init_decay_epoch // 2
  losses, full_losses, step_s = [], [], []
  no_vv_step = None
  divisor_prev = schedule_events[-1]["divisor"] if schedule_events else -1
  epoch_prev, weights = -1, None
  # batch k is step start_step + k + 1's: epoch (start_step + k) // frames
  sampler = curriculum_sampler(data, config, 0, skip=start_step)
  with PrefetchPipeline(sampler, num_workers=config.workers,
                        seed=start_step, device=dev) as pipe:
    for step in range(start_step + 1, args.steps + 1):
      epoch = (step - 1) // frames
      if epoch != epoch_prev:
        weights = schedule_weights(t_cfg, epoch)
        divisor = epoch // config.init_decay_epoch
        if divisor != divisor_prev:
          ev = {"step": step, "epoch": epoch, "divisor": divisor,
                "w_disp": weights.w_disp, "w_flow": weights.w_flow,
                "dynamic_rgb_decay": weights.dynamic_rgb_decay,
                "use_dynamic_mask_rgb": weights.use_dynamic_mask_rgb,
                "suppress_dynamic": weights.suppress_dynamic}
          schedule_events.append(ev)
          print(f"schedule: {ev}", flush=True)
          divisor_prev = divisor
        # the one-shot pre-virtual-view snapshot (reference
        # train.py:503-506), once per run folder as cli/train writes it
        if (epoch == config.init_decay_epoch * 5
            and ckpt_lib.latest_checkpoint(ckpt_dir, NO_VV) is None):
          ckpt_lib.save_checkpoint(ckpt_dir, step - 1, model.state_dict(),
                                   opt.state_dict(), name=NO_VV)
          no_vv_step = step - 1
          print(f"saved {NO_VV} at step {step - 1} (epoch {epoch})",
                flush=True)
        epoch_prev = epoch
      rb = next(pipe)
      t0 = time.perf_counter()
      bootstrap = epoch < n_bootstrap_epochs
      loss, metrics, _ = mono_train_step(model, opt, rb, weights, cfg, t_cfg,
                                         bootstrap=bootstrap, generator=gen)
      loss = float(loss)                # a host sync: honest step times
      if step > start_step + 1:         # the first step loads the kernels
        step_s.append(time.perf_counter() - t0)
      losses.append(loss)
      if not bootstrap:
        full_losses.append(loss)
      if step % config.i_print == 0:
        print(f"step {step} epoch {epoch} loss={loss:.4f} "
              f"psnr_batch={float(metrics['psnr']):.2f} "
              f"gnorm={float(metrics['grad_norm']):.2f} "
              f"({np.mean(step_s[-20:] or [0]):.3f} s/step)", flush=True)
      if step % args.eval_every == 0 or step == args.steps:
        rec = evaluate(step)
        rec["loss"] = float(np.mean(losses[-50:]))
        rec["psnr_batch"] = float(metrics["psnr"])
        for k in TERM_KEYS:             # the last batch's terms
          if k in metrics:
            rec[k] = float(metrics[k])
        curve.append(rec)
        print("eval:", {k: round(v, 4) for k, v in rec.items()},
              f"{np.mean(step_s or [0]):.4f} s/step", flush=True)
        ckpt_lib.save_checkpoint(ckpt_dir, step, model.state_dict(),
                                 opt.state_dict(), keep=2)
        with open(out_path, "w") as fh:         # a partial record
          json.dump({"partial": True, "tag": args.tag, "steps_done": step,
                     "schedule_events": schedule_events,
                     "sec_per_step_mean": (float(np.mean(step_s))
                                           if step_s else None),
                     "curve": _round(curve)}, fh, indent=2)

  no_vv = ckpt_lib.latest_checkpoint(ckpt_dir, NO_VV)
  result = {
      "tag": args.tag, "device": card, "steps": args.steps,
      "start_step": start_step,
      "config": {
          "N_rand": config.N_rand, "N_samples": config.N_samples,
          "frames": frames, "hw": [scene.h, scene.w],
          "clip_grad_norm": float(args.clip),
          "init_decay_epoch": config.init_decay_epoch,
          "compute_dtype": config.compute_dtype,
          "routes": [cfg.fused_bwd_impl, cfg.fused_st_bwd_impl]},
      # this run's steps (a resumed run times only the steps it ran)
      "sec_per_step_mean": float(np.mean(step_s)) if step_s else None,
      "run_seconds": time.perf_counter() - t_run,
      "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                   if dev.type == "cuda" else None),
      # this run's full-phase losses, one per step
      "full_losses": [round(x, 6) for x in full_losses],
      # from the JSON's figures, so that a resumed run reports the same
      "final": {k: round(v, 3) for k, v in _round(curve)[-1].items()},
      "init": {k: round(v, 3) for k, v in _round(curve)[0].items()},
      # the loss drop within the full phase, or over the whole run when
      # the full phase is shorter than 8 steps (as the JAX script)
      **gate(curve, full_losses if len(full_losses) >= 8 else losses,
             args.gate_db, args.quick),
      "schedule_events": schedule_events,
      "no_vv_snapshot": os.path.basename(no_vv) if no_vv else None,
      "no_vv_written_at": no_vv_step,
      "gate_db": args.gate_db,
      "curve": _round(curve),
  }
  with open(out_path, "w") as fh:
    json.dump(result, fh, indent=2)
  print(json.dumps({k: v for k, v in result.items()
                    if k not in ("curve", "full_losses")}), flush=True)
  print(f"wrote {out_path}", flush=True)
  return result


def main(argv=None) -> dict:
  """Run, then exit 1 on a failed gate unless ``--quick``."""
  args = parse_args(argv)
  result = run(args)
  enforce_gate(result, args.quick)
  return result


if __name__ == "__main__":
  main()
