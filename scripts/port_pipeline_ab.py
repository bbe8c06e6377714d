"""The training CLIs' s/step and data-pipeline wait, for one or more
checkouts of the repository in one call.

    python3 scripts/port_pipeline_ab.py TREE [TREE ...] [--out DIR]

Each TREE is the root of a checkout (name checkouts more than once to
interleave them, e.g. ``parent . . parent``).  For each, in the order
given, a fresh interpreter with TREE first on ``sys.path`` runs on the
CUDA card, at the settings of ``chip_smoke.py``:

  * phase 8: ``cli/train.main`` over a 48-frame 288x512 scene, one
    bootstrap and one phase-2 epoch of 48 steps at N_rand 3072 (64
    samples, route ``pallas``, bf16, 4 loader threads), no panel;
  * phase 11c: 48 ``ff_coarse_train_step`` steps from a
    ``PrefetchPipeline`` (4 threads) over a 24-frame 288x512
    ``ConsistentScene`` in the Nvidia layout, then ``cli/train_ff.main``
    for one epoch of 24 steps, both at
    ``configs_nvidia/eval_balloon1_long.txt`` (N_rand 3072; the CLI
    grafts the coarse stage's snapshot);

and prints one JSON line per phase: its steps, seconds per step and the
host seconds the step loop spent in the pipeline's ``__next__``
(``wait_s``), as the CLIs log them, and the card's name and power
limit.  The scenes are written once, by the
first TREE, under ``--out`` (default a temporary directory, removed at
the end).  A TREE without ``build/kernels`` gets a link to the first
TREE's, so the kernels (one name per source hash) are built once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

H, W, N_RAND = 288, 512, 3072
MONO_FRAMES, FF_FRAMES, COARSE_STEPS = 48, 24, 48
MONO_SCENE, FF_SCENE = "scene", "consistent_nvidia"


def _phases(metrics_path):
  """The phase records ("phase/<name>/<key>") of a CLI's metrics log."""
  out = {}
  with open(metrics_path) as fh:
    for line in fh:
      rec = json.loads(line)
      for k, v in rec.items():
        if k.startswith("phase/"):
          _, name, key = k.split("/")
          out.setdefault(name, {})[key] = v
  return out


def _card() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def _emit(tree, phase, steps, seconds, wait_s):
  print(json.dumps({"tree": tree, "phase": phase, "steps": steps,
                    "s_per_step": seconds / steps, "wait_s": wait_s,
                    "card": _card()}), file=sys.__stdout__, flush=True)


def child(tree: str, scenes: str, rootdir: str) -> None:
  """One TREE's runs (its package is first on sys.path); the CLIs' own
  output goes to ``<rootdir>.log``."""
  os.makedirs(rootdir, exist_ok=True)
  with open(rootdir + ".log", "w") as log, \
      contextlib.redirect_stdout(log):
    _child(tree, scenes, rootdir)


def _child(tree: str, scenes: str, rootdir: str) -> None:
  import numpy as np
  import torch
  from dynibar_tpu_torch.cli import train, train_ff
  from dynibar_tpu_torch.config import INIT_SEED, STEP_SEED, DynibarConfig
  from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
  from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
  from dynibar_tpu_torch.models.dynibar import FFModel
  from dynibar_tpu_torch.ops import build
  from dynibar_tpu_torch.train import losses, trainer
  from dynibar_tpu_torch.utils import checkpoints as ckpt
  build.build()
  dev = torch.device("cuda")

  # phase 8's CLI run, without its panel and mid-phase checkpoint
  args = ["--folder_path", scenes, "--train_scenes", MONO_SCENE,
          "--rootdir", rootdir, "--training_height", str(H),
          "--N_rand", str(N_RAND), "--N_samples", "64",
          "--num_source_views", "7", "--num_vv", "3", "--num_basis", "6",
          "--fused_bwd_impl", "pallas", "--init_decay_epoch", "2",
          "--compute_dtype", "bfloat16", "--i_img", "100000",
          "--i_weights", "100000", "--i_print", "24", "--workers", "4",
          "--chunk_size", "4096", "--n_iters", str(MONO_FRAMES)]
  out = train.main(args)["out_folder"]
  logs = os.path.join(rootdir, "logs", os.path.basename(out))
  for name, rec in _phases(os.path.join(logs, "metrics.jsonl")).items():
    _emit(tree, f"8 cli {name}", rec["steps"], rec["seconds"],
          rec["wait_s"])

  # phase 11c's coarse stage: a pipeline over NvidiaSceneData
  config_file = os.path.join(tree, "configs_nvidia",
                             "eval_balloon1_long.txt")
  config = DynibarConfig.from_file(
      config_file, folder_path=scenes, rootdir=rootdir,
      eval_scenes=[FF_SCENE], N_rand=N_RAND, workers=4, chunk_size=4096,
      training_height=H)
  cfg = config.render_settings("ff_train")
  data = NvidiaSceneData(config, FF_SCENE, cfg=cfg, height=H)
  config.num_frames = data.num_frames
  t_cfg = config.train_settings()
  model = FFModel(cfg, FF_FRAMES, device=dev, seed=INIT_SEED).train_coarse()
  opt = trainer.make_ff_coarse_optimizer(model, t_cfg)
  gen = torch.Generator(dev).manual_seed(STEP_SEED)
  curve = []
  # one second parameter with a default: the batch index where the
  # pipeline passes one, nothing where it does not
  with PrefetchPipeline(lambda r, _=None: data.sample_batch(r, N_RAND),
                        num_workers=4, seed=0, device=dev) as pipe:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(COARSE_STEPS):
      epoch = i // FF_FRAMES
      loss, _, _ = trainer.ff_coarse_train_step(
          model, opt, next(pipe), losses.schedule_weights(t_cfg, epoch),
          cfg, t_cfg, generator=gen)
      curve.append(loss)
    curve = [float(x) for x in curve]
    seconds = time.perf_counter() - t0
    wait = pipe.wait_s
  if not np.isfinite(curve).all():
    raise AssertionError(f"coarse stage: non-finite loss {curve}")
  _emit(tree, "11c coarse", COARSE_STEPS, seconds, wait)
  coarse_dir = os.path.join(rootdir, "coarse_run")
  ckpt.save_checkpoint(coarse_dir, COARSE_STEPS, model.state_dict(),
                       opt.state_dict())
  del model, opt
  torch.cuda.empty_cache()

  # phase 11c's cli/train_ff run
  train_ff.main(["--config", config_file, "--folder_path", scenes,
                 "--rootdir", rootdir, "--eval_scenes", FF_SCENE,
                 "--coarse_dir", coarse_dir,
                 "--training_height", str(H), "--N_rand", str(N_RAND),
                 "--n_iters", str(FF_FRAMES - 1), "--i_print", "1",
                 "--i_weights", "100000", "--workers", "4",
                 "--expname", "ab"])
  rec = _phases(os.path.join(rootdir, "logs", "fine_ab",
                             "metrics.jsonl"))["fine"]
  _emit(tree, "11c cli fine", rec["steps"], rec["seconds"], rec["wait_s"])


def write_scenes(scenes: str) -> None:
  from dynibar_tpu_torch.data.synthetic_scene import (ConsistentScene,
                                                      write_synthetic_scene)
  t0 = time.perf_counter()
  write_synthetic_scene(scenes, MONO_SCENE, num_frames=MONO_FRAMES,
                        height=H, width=W)
  ConsistentScene(num_frames=FF_FRAMES, height=H, width=W).write_nvidia(
      scenes, FF_SCENE)
  print(f"wrote the scenes in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("trees", nargs="*")
  ap.add_argument("--out", default=None)
  ap.add_argument("--child", nargs=3, metavar=("TREE", "SCENES", "ROOT"))
  ap.add_argument("--write_scenes", default=None)
  args = ap.parse_args()
  if args.child:
    child(*args.child)
    return 0
  if args.write_scenes:
    write_scenes(args.write_scenes)
    return 0
  trees = [os.path.abspath(t) for t in args.trees]
  if not trees:
    ap.error("name at least one checkout")
  if args.out is None:
    with tempfile.TemporaryDirectory() as out:
      return compare(trees, out)
  return compare(trees, os.path.abspath(args.out))


def compare(trees, out: str) -> int:
  scenes = os.path.join(out, "scenes")
  print(f"card: {_card()}", flush=True)
  first_build = os.path.join(trees[0], "build", "kernels")

  def run(tree, *argv):
    env = dict(os.environ, PYTHONPATH=tree)
    subprocess.run([sys.executable, os.path.abspath(__file__), *argv],
                   cwd=tree, env=env, check=True)

  run(trees[0], "--write_scenes", scenes)
  for i, tree in enumerate(trees):
    kernels = os.path.join(tree, "build", "kernels")
    if i and not os.path.exists(kernels):
      os.makedirs(os.path.dirname(kernels), exist_ok=True)
      os.symlink(first_build, kernels)
    run(tree, "--child", tree, scenes, os.path.join(out, f"run{i}"))
  return 0


if __name__ == "__main__":
  sys.exit(main())
