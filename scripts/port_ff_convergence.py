"""FF (forward-facing / Nvidia benchmark) convergence run of the PyTorch
port: both training stages on the analytic scene, gated on held-out
novel views.

The port's counterpart of ``scripts/ff_convergence_run.py``.  It writes
``ConsistentScene.write_nvidia`` (the 12-camera round-robin rig with exact
ground truth at any pose and time) and trains

  phase A  the coarse stage (``ff_coarse_train_step``: the run that
           produces the frozen coarse stage google/dynibar ships only as
           data, model.py:102), then
  phase B  the fine stage on the frozen phase-A coarse stage
           (``create_ff_train_state`` + ``ff_train_step``, the reference
           optimizer layout model.py:106-118).

Gate (the JAX script's): on two held-out (viewpoint, time) pairs
(``eval/held_out.py``) the fine render's crop-3% PSNR must rise by at
least ``--gate_db`` over its phase-B init and end above the frozen-coarse
render.  Every eval writes ``<outdir>/ff_convergence_<tag>.json`` (a
partial record until the end) and a snapshot of the phase's model and
optimizer; ``--resume`` continues phase A or B from those snapshots.
Renders and the JSON go under ``--outdir`` only.

    python scripts/port_ff_convergence.py --outdir build/ffconv   # card
    python scripts/port_ff_convergence.py --quick --outdir DIR    # CPU

``--quick`` runs a tiny configuration on the CPU (plain twins, f32) and
reports the gate without enforcing it; otherwise a failed gate exits 1.
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


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--coarse_steps", type=int, default=1500)
  ap.add_argument("--fine_steps", type=int, default=2500)
  ap.add_argument("--eval_every", type=int, default=250)
  ap.add_argument("--frames", type=int, default=None,
                  help="default 48 (24 with --quick)")
  ap.add_argument("--height", type=int, default=None,
                  help="default 96 (32 with --quick)")
  ap.add_argument("--width", type=int, default=None,
                  help="default 144 (48 with --quick)")
  ap.add_argument("--n_rand", type=int, default=3072)
  ap.add_argument("--n_rand_fine", type=int, default=2048,
                  help="phase-B ray batch (the JAX script's default)")
  ap.add_argument("--outdir", type=str, required=True)
  ap.add_argument("--tag", type=str, default="ff")
  ap.add_argument("--gate_db", type=float, default=5.0,
                  help="required fine PSNR rise over phase-B init (dB)")
  ap.add_argument("--clip", type=float, default=1.0,
                  help="global-norm gradient clip")
  ap.add_argument("--quick", action="store_true",
                  help="tiny CPU run: 12 + 12 samples, f32, at most 60 + 60 "
                       "steps of 128 rays; the gate is reported, not "
                       "enforced")
  ap.add_argument("--resume", action="store_true",
                  help="continue phase A and B from their snapshots")
  return ap.parse_args(argv)


def build(args):
  """(scene, config, render settings, train settings, data); writes the
  scene unless it is there."""
  from dynibar_tpu_torch.config import DynibarConfig
  from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
  from dynibar_tpu_torch.data.synthetic_scene import ConsistentScene

  for key, full, quick in (("frames", 48, 24), ("height", 96, 32),
                           ("width", 144, 48)):
    if getattr(args, key) is None:
      setattr(args, key, quick if args.quick else full)
  if args.quick:
    args.coarse_steps = min(args.coarse_steps, 60)
    args.fine_steps = min(args.fine_steps, 60)
    args.eval_every = min(args.eval_every, 30)
    args.n_rand = min(args.n_rand, 128)
  scene = ConsistentScene(num_frames=args.frames, height=args.height,
                          width=args.width)
  root = os.path.join(args.outdir,
                      f"scene_{args.frames}x{args.height}x{args.width}")
  name = "consistent_nvidia"
  if not os.path.exists(os.path.join(root, name, "dense",
                                     "poses_bounds_cvd.npy")):
    os.makedirs(root, exist_ok=True)
    scene.write_nvidia(root, name)
    print(f"wrote nvidia-layout scene to {root}", flush=True)

  common = dict(
      folder_path=root, train_scenes=[name], training_height=args.height,
      N_rand=args.n_rand, num_source_views=7, init_decay_epoch=40,
      chunk_size=512 if args.quick else 2048, clip_grad_norm=args.clip,
      mask_static=False, workers=2, i_print=50)
  if args.quick:
    config = DynibarConfig(N_samples=12, N_importance=12, num_basis=4,
                           compute_dtype="float32", **common)
  else:
    config = DynibarConfig(N_samples=64, N_importance=64, num_basis=6,
                           compute_dtype="bfloat16", **common)
  cfg = config.render_settings("ff_train")
  data = NvidiaSceneData(config, name, cfg=cfg, height=args.height)
  config.num_frames = data.num_frames
  config.lrate_decay_steps = config.num_frames * config.init_decay_epoch
  return scene, config, cfg, config.train_settings(), data


def _round(curve):
  return [{k: (round(float(v), 4) if isinstance(v, (int, float)) else v)
           for k, v in r.items()} for r in curve]


def main(argv=None) -> dict:
  args = parse_args(argv)
  os.makedirs(args.outdir, exist_ok=True)
  from dynibar_tpu_torch.config import INIT_SEED
  from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
  from dynibar_tpu_torch.eval.held_out import eval_ff, held_out_views
  from dynibar_tpu_torch.models.dynibar import FF_COARSE_KEYS, FFModel
  from dynibar_tpu_torch.train.losses import schedule_weights
  from dynibar_tpu_torch.train.trainer import (create_ff_train_state,
                                               ff_coarse_train_step,
                                               ff_train_step,
                                               make_ff_coarse_optimizer)
  from dynibar_tpu_torch.utils import checkpoints as ckpt_lib
  from dynibar_tpu_torch.utils.device import resolve_device

  dev = resolve_device("cpu" if args.quick else None)
  scene, config, cfg, t_cfg, data = build(args)
  views = held_out_views(scene, data)
  imgdir = os.path.join(args.outdir, f"renders_{args.tag}")
  os.makedirs(imgdir, exist_ok=True)
  out_path = os.path.join(args.outdir, f"ff_convergence_{args.tag}.json")
  ckpt_dir = {p: os.path.join(args.outdir, f"ckpt_{args.tag}_{p}")
              for p in ("A", "B")}
  card = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
  print(f"[{args.tag}] device={card} frames={data.num_frames} "
        f"{scene.h}x{scene.w} N_rand={config.N_rand}/{args.n_rand_fine} "
        f"A={args.coarse_steps} B={args.fine_steps}", flush=True)

  curve, step_s = [], {"A": [], "B": []}
  if args.resume and os.path.exists(out_path):
    with open(out_path) as fh:
      curve = json.load(fh).get("curve", [])

  def evaluate(model, phase, step):
    rec = eval_ff(model, data, cfg, config.chunk_size, views,
                  outdir=imgdir, step=step, tag=phase)
    rec.update(step=step, phase=phase)
    return rec

  def resume(phase, model, opt):
    """The phase's newest snapshot into model and opt: its step, or 0."""
    path = ckpt_lib.latest_checkpoint(ckpt_dir[phase]) if args.resume else None
    if path is None:
      return 0
    payload = ckpt_lib.load_checkpoint(path, map_location=dev)
    model.load_state_dict(payload["model"])
    opt.load_state_dict(payload["optimizer"])
    # drop the curve's records of this phase past the snapshot
    curve[:] = [r for r in curve
                if r["phase"] != phase or r["step"] <= payload["step"]]
    print(f"resumed phase {phase} from {path}", flush=True)
    return int(payload["step"])

  def run_phase(model, opt, step_fn, steps, phase, start):
    n_rand = (config.N_rand if phase == "A"
              else min(config.N_rand, args.n_rand_fine))
    gen = torch.Generator(dev).manual_seed((11 if phase == "A" else 23)
                                           + start)
    losses = []
    with PrefetchPipeline(lambda r, _: data.sample_batch(r, n_rand),
                          num_workers=config.workers,
                          seed=(0 if phase == "A" else 1) + start,
                          device=dev) as pipe:
      epoch, weights = -1, None
      for step in range(start + 1, steps + 1):
        if step // data.num_frames != epoch:
          epoch = step // data.num_frames
          data.set_epoch(epoch)
          weights = schedule_weights(t_cfg, epoch)
        rb = next(pipe)
        t0 = time.perf_counter()
        loss, metrics, _ = step_fn(model, opt, rb, weights, cfg, t_cfg,
                                   generator=gen)
        loss = float(loss)                      # a host sync
        step_s[phase].append(time.perf_counter() - t0)
        losses.append(loss)
        if step % config.i_print == 0:
          print(f"[{phase}] step {step} loss={loss:.4f} "
                f"psnr_batch={float(metrics['psnr']):.2f} "
                f"gnorm={float(metrics['grad_norm']):.2f} "
                f"({np.mean(step_s[phase][-20:]):.3f} s/step)", flush=True)
        if step % args.eval_every == 0 or step == steps:
          rec = evaluate(model, phase, step)
          rec["loss"] = float(np.mean(losses[-50:]))
          curve.append(rec)
          print(f"eval[{phase}]:", {k: round(v, 2) for k, v in rec.items()
                                    if isinstance(v, float)}, flush=True)
          with open(out_path, "w") as fh:      # a partial record
            json.dump({"partial": True, "tag": args.tag,
                       "curve": _round(curve)}, fh, indent=2)
          ckpt_lib.save_checkpoint(ckpt_dir[phase], step, model.state_dict(),
                                   opt.state_dict(), keep=2)

  # ---- phase A: the coarse stage ----
  model_a = FFModel(cfg, data.num_frames, device=dev,
                    seed=INIT_SEED).train_coarse()
  opt_a = make_ff_coarse_optimizer(model_a, t_cfg)
  start_a = resume("A", model_a, opt_a)
  if start_a == 0:
    curve[:] = [evaluate(model_a, "A", 0)]
    print("init:", {k: round(v, 2) for k, v in curve[0].items()
                    if isinstance(v, float)}, flush=True)
  if start_a < args.coarse_steps:
    run_phase(model_a, opt_a, ff_coarse_train_step, args.coarse_steps, "A",
              start_a)
  coarse = {k: v for k, v in model_a.state_dict().items()
            if k.split(".")[0] in FF_COARSE_KEYS}
  del model_a, opt_a

  # ---- phase B: the fine stage on the frozen coarse stage ----
  model_b, opt_b = create_ff_train_state(cfg, t_cfg, data.num_frames,
                                         device=dev, seed=INIT_SEED + 1,
                                         coarse=coarse)
  start_b = resume("B", model_b, opt_b)
  if not any(r["phase"] == "B" for r in curve):
    curve.append(evaluate(model_b, "B", start_b))
    print("phase-B init:", {k: round(v, 2) for k, v in curve[-1].items()
                            if isinstance(v, float)}, flush=True)
  rec_b0 = min((r for r in curve if r["phase"] == "B"),
               key=lambda r: r["step"])
  if start_b < args.fine_steps:
    run_phase(model_b, opt_b, ff_train_step, args.fine_steps, "B", start_b)

  final = curve[-1]
  fine_keys = [k for k in final if k.startswith("psnr_")
               and k.endswith("_fine_crop3")]
  rise = min(final[k] - rec_b0[k] for k in fine_keys)
  above = min(final[k] - rec_b0[k.replace("_fine_", "_coarse_")]
              for k in fine_keys)
  result = {
      "tag": args.tag, "device": card,
      "coarse_steps": args.coarse_steps, "fine_steps": args.fine_steps,
      "config": {"N_rand": config.N_rand, "N_rand_fine": args.n_rand_fine,
                 "N_samples": config.N_samples,
                 "N_importance": config.N_importance,
                 "frames": data.num_frames, "hw": [scene.h, scene.w],
                 "clip_grad_norm": float(args.clip),
                 "compute_dtype": config.compute_dtype},
      # this run's steps (a resumed run times only the steps it ran)
      "s_per_step": {p: (float(np.mean(s)) if s else None)
                     for p, s in step_s.items()},
      "final": _round([final])[0],
      "fine_init": _round([rec_b0])[0],
      "coarse_only_psnr": {k.replace("_fine_", "_coarse_"): round(
          float(rec_b0[k.replace("_fine_", "_coarse_")]), 3)
                           for k in fine_keys},
      "fine_rise_db": round(float(rise), 3),
      "fine_minus_frozen_coarse_db": round(float(above), 3),
      "gate_db": args.gate_db,
      "gate_passed": bool(rise >= args.gate_db and above > 0),
      "curve": _round(curve),
  }
  with open(out_path, "w") as fh:
    json.dump(result, fh, indent=2)
  print(json.dumps({k: v for k, v in result.items() if k != "curve"}),
        flush=True)
  if not result["gate_passed"] and not args.quick:
    print(f"GATE FAILED: fine rise {result['fine_rise_db']} dB (gate "
          f"{args.gate_db}), fine - frozen coarse "
          f"{result['fine_minus_frozen_coarse_db']} dB", file=sys.stderr)
    sys.exit(1)
  return result


if __name__ == "__main__":
  main()
