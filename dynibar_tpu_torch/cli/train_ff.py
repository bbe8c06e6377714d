"""Forward-facing (Nvidia benchmark) fine-stage training CLI.

Port of ``dynibar_tpu.cli.train_ff``: google/dynibar's DynibarFF optimizer
layout (reference model.py:106-118: the fine nets, feature_net_fine,
motion_mlp_fine and traj_basis_fine trained, the coarse stage loaded
frozen from ``coarse_dir``) driven by ``ff_train_step`` over
``NvidiaSceneData`` batches from a ``PrefetchPipeline``.  ``coarse_dir``
is a port run folder (its newest snapshot's coarse groups, loaded
strictly: a mono run's snapshot is read the same way) or a reference
coarse ``.pth``; without it the coarse stage keeps its seeded weights, as
in the JAX CLI.  Snapshots go to ``<rootdir>/checkpoints/fine/<expname>``
(with ``args.json``) every ``i_weights`` steps and at the end, scalars
under ``train_fine/`` every ``i_print`` steps to
``<rootdir>/logs/fine_<expname>``, and at the end one record
``phase/fine/...``: the steps, their seconds and the seconds the step
loop spent getting its batches from the pipeline.  It resumes from the
newest snapshot in the out folder (or ``ckpt_path``).

    python -m dynibar_tpu_torch.cli.train_ff --config <file> \\
        --coarse_dir <run folder or coarse .pth> [--device cpu]

Every ``--key value`` after the config sets that field of
``DynibarConfig``; ``--device cpu`` runs the plain PyTorch twins of the
kernels on the CPU, and without it the CLI needs the CUDA card.  Under
``torchrun`` one process per card trains one model, as ``cli/train`` does
(``N_rand`` global, rank 0 writes, every rank resumes from rank 0's
snapshot).  The coarse stage itself trains through
``train/trainer.ff_coarse_train_step`` (``scripts/port_ff_convergence.py``
phase A).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from dynibar_tpu_torch.cli.train import _save, _sync, parse_args
from dynibar_tpu_torch.config import INIT_SEED, STEP_SEED
from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
from dynibar_tpu_torch.models.dynibar import FF_COARSE_KEYS
from dynibar_tpu_torch.parallel.mesh import (agree, replicate,
                                             training_mesh)
from dynibar_tpu_torch.train.losses import schedule_weights
from dynibar_tpu_torch.train.trainer import (create_ff_train_state,
                                             ff_train_step)
from dynibar_tpu_torch.utils import checkpoints as ckpt_lib
from dynibar_tpu_torch.utils import convert
from dynibar_tpu_torch.utils.device import resolve_device
from dynibar_tpu_torch.utils.logging import MetricsLogger


def load_coarse_params(coarse_dir: str
                       ) -> Optional[Dict[str, torch.Tensor]]:
  """The frozen coarse stage's state_dict entries (FF_COARSE_KEYS) from a
  reference coarse ``.pth`` or a port run folder's newest snapshot
  (dynibar_tpu/cli/train_ff.py:40-53); None when ``coarse_dir`` is
  empty.  ``create_ff_train_state`` grafts them strictly."""
  if not coarse_dir:
    return None
  if coarse_dir.endswith(".pth"):
    return convert.read_reference_groups(coarse_dir, FF_COARSE_KEYS)
  path = ckpt_lib.latest_checkpoint(coarse_dir)
  if path is None:
    raise SystemExit(f"no checkpoint found under coarse_dir={coarse_dir}")
  sd = ckpt_lib.load_checkpoint(path, map_location="cpu")["model"]
  return {k: v for k, v in sd.items() if k.split(".")[0] in FF_COARSE_KEYS}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
  """Run the CLI; returns the out folder and the step it started from."""
  config, device = parse_args(argv)
  scenes = config.train_scenes or config.eval_scenes
  if not scenes:
    raise SystemExit("error: no scene: pass --config <file> with "
                     "`train_scenes = <scene>` or --train_scenes <scene>")
  mesh = training_mesh(config, device)
  dev = mesh.device if mesh is not None else resolve_device(device)
  is_main = mesh is None or mesh.is_main
  if mesh is not None:
    mesh.rows(config.N_rand)          # N_rand must split over the ranks

  cfg = config.render_settings("ff_train")
  data = NvidiaSceneData(config, scenes[0], cfg=cfg,
                         height=config.training_height)
  config.num_frames = data.num_frames
  if config.lrate_decay_steps <= 0:
    config.lrate_decay_steps = data.num_frames * config.init_decay_epoch
  t_cfg = config.train_settings()

  out_folder = os.path.join(config.rootdir, "checkpoints", "fine",
                            config.expname)
  if is_main:
    os.makedirs(out_folder, exist_ok=True)
    with open(os.path.join(out_folder, "args.json"), "w") as fh:
      json.dump(vars(config), fh, indent=2, default=str)

  model, opt = create_ff_train_state(
      cfg, t_cfg, data.num_frames, device=dev, seed=INIT_SEED,
      coarse=load_coarse_params(config.coarse_dir))
  if is_main:
    print(f"[{config.expname}] coarse stage: "
          f"{config.coarse_dir or 'seeded (no coarse_dir)'}", flush=True)
  payload, start_step = ckpt_lib.resume_from(
      out_folder, config.ckpt_path, config.no_reload, map_location=dev)
  if payload is not None:
    model.load_state_dict(payload["model"])
    if not config.no_load_opt and "optimizer" in payload:
      opt.load_state_dict(payload["optimizer"])
    if is_main:
      print(f"resumed at step {start_step}", flush=True)
  if mesh is not None:
    agree(mesh, start_step, "the resumed step")
    replicate(mesh, model, opt)

  logger = MetricsLogger(os.path.join(config.rootdir, "logs",
                                      "fine_" + config.expname),
                         enabled=is_main)
  gen = torch.Generator(device=dev).manual_seed(STEP_SEED)
  global_step = start_step

  def sample(np_rng, _):
    return data.sample_batch(np_rng, config.N_rand)

  try:
    with PrefetchPipeline(sample, num_workers=config.workers, seed=0,
                          device=dev) as pipe:
      t0 = t_print = time.perf_counter()
      steps = 0
      while global_step < start_step + config.n_iters + 1:
        epoch = global_step // data.num_frames
        data.set_epoch(epoch)
        weights = schedule_weights(t_cfg, epoch)
        rb = next(pipe)
        _, metrics, _ = ff_train_step(model, opt, rb, weights, cfg, t_cfg,
                                      generator=gen, mesh=mesh)
        global_step += 1
        steps += 1

        if global_step % config.i_print == 0:
          vals = {k: float(v) for k, v in metrics.items()}
          vals["steps_per_sec"] = config.i_print / (time.perf_counter()
                                                    - t_print)
          t_print = time.perf_counter()
          logger.scalars(global_step, vals, prefix="train_fine/")
          if is_main:
            print(f"[{config.expname}] step {global_step} "
                  + " ".join(f"{k}={v:.5f}" for k, v in vals.items()),
                  flush=True)

        if global_step % config.i_weights == 0 and is_main:
          _save(out_folder, global_step, model, opt)
          print(f"saved checkpoint at {global_step}", flush=True)
      _sync(dev)
      rec = {"steps": steps, "seconds": time.perf_counter() - t0,
             "wait_s": pipe.wait_s}
    logger.scalars(global_step, rec, prefix="phase/fine/")
    if is_main:
      print(f"[{config.expname}] fine: " + " ".join(
          f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
          for k, v in rec.items()), flush=True)
      _save(out_folder, global_step, model, opt)
  finally:
    logger.close()
  return {"out_folder": out_folder, "start_step": start_step}


if __name__ == "__main__":
  main(sys.argv[1:])
