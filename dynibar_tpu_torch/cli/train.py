"""Monocular training CLI.

Port of ``dynibar_tpu.cli.train`` (reference train.py:47-573): read the
scene from disk, bootstrap the static model for ``init_decay_epoch // 2``
epochs (phase 1), then run the full 8-term loss until ``n_iters`` (phase
2); scalars every ``i_print`` steps, a checkpoint every ``i_weights``,
full-frame image panels every ``i_img``, and a last checkpoint at the end.
It resumes from the newest snapshot in the experiment folder.  At the end
of each phase it prints and logs (``phase/<name>/...``) the phase's steps,
their seconds less the panels', the seconds the step loop spent getting
its batches from the data pipeline, and the panels' count and seconds.

    python -m dynibar_tpu_torch.cli.train --config configs/train_example.txt
    python -m dynibar_tpu_torch.cli.train --config <file> --device cpu
    python -m torch.distributed.run --nproc_per_node 4 \
        -m dynibar_tpu_torch.cli.train --config <file>

Every ``--key value`` after the config sets that field of
``DynibarConfig``; ``--device cpu`` runs on the CPU (the plain PyTorch
twins of the kernels), and without it the CLI needs the CUDA card.  Under
``torchrun`` one process per card trains one model (``parallel/mesh.py``):
``N_rand`` is the global batch, which every rank draws alike and of which
it renders its rows, and the step equals one card's.  Only rank 0 writes
(``args.json``, the logs, the snapshots, the panels, which it renders
alone); every rank resumes from the same snapshot, broadcast from rank 0.
The one-shot ``model_no-vv`` snapshot is written once
per experiment folder, as google/dynibar's train.py:503-506 guards it
(the JAX CLI writes it again on every resume that reaches its epoch).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dynibar_tpu_torch.config import INIT_SEED, STEP_SEED, DynibarConfig
from dynibar_tpu_torch.data.factory import create_training_dataset
from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
from dynibar_tpu_torch.models.dynibar import MonoModel
from dynibar_tpu_torch.parallel.mesh import (agree, replicate,
                                             training_mesh)
from dynibar_tpu_torch.train.losses import schedule_weights
from dynibar_tpu_torch.train.trainer import (make_mono_optimizer,
                                             mono_train_step)
from dynibar_tpu_torch.train.view_logging import log_train_view
from dynibar_tpu_torch.utils import checkpoints as ckpt_lib
from dynibar_tpu_torch.utils.device import resolve_device
from dynibar_tpu_torch.utils.logging import MetricsLogger

NO_VV = "model_no-vv"


def parse_args(argv: Optional[List[str]] = None):
  """(DynibarConfig, device or None): ``--config`` and ``--device``, then
  ``--key value`` overrides of the config's fields."""
  ap = argparse.ArgumentParser()
  ap.add_argument("--config", type=str, default=None)
  ap.add_argument("--device", type=str, default=None,
                  help="'cpu' for the plain path; default the CUDA card")
  known, extra = ap.parse_known_args(argv)
  overrides = {}
  it = iter(extra)
  for tok in it:
    if tok.startswith("--"):
      overrides[tok[2:]] = next(it, "true")
  cfg = (DynibarConfig.from_file(known.config) if known.config
         else DynibarConfig())
  for k, v in overrides.items():
    if hasattr(cfg, k):
      cur = getattr(cfg, k)
      if isinstance(cur, bool):
        v = v.lower() in ("1", "true", "yes")
      elif isinstance(cur, int):
        v = int(v)
      elif isinstance(cur, float):
        v = float(v)
      elif isinstance(cur, list):
        v = v.split()
      setattr(cfg, k, v)
  return cfg, known.device


def _sync(dev: torch.device) -> None:
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


def _save(out_folder, step, model, opt, name="model"):
  return ckpt_lib.save_checkpoint(out_folder, step, model.state_dict(),
                                  opt.state_dict(), name=name)


def curriculum_sampler(data, config, start_epoch: int, skip: int = 0):
  """A phase's pipeline function: the phase starts ``skip`` batches into
  epoch ``start_epoch`` (the CLI's phases run whole epochs: 0), so batch
  ``k`` falls in epoch ``start_epoch + (skip + k) // num_frames`` and
  draws under that epoch's anchor curriculum, however far its loader
  thread runs ahead of the step loop."""
  def sample(np_rng, k):
    return data.sample_batch(
        np_rng, config.N_rand, config.sample_mode,
        epoch=start_epoch + (skip + k) // data.num_frames)
  return sample


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
  """Run the CLI; returns the out folder and the step it started from."""
  config, device = parse_args(argv)
  if not config.train_scenes:
    raise SystemExit("error: no training scene: pass --config <file> with "
                     "`train_scenes = <scene>` or --train_scenes <scene>")
  mesh = training_mesh(config, device)
  dev = mesh.device if mesh is not None else resolve_device(device)
  is_main = mesh is None or mesh.is_main
  if mesh is not None:
    mesh.rows(config.N_rand)          # N_rand must split over the ranks

  data = create_training_dataset(config)
  config.num_frames = data.num_frames
  config.lrate_decay_steps = config.num_frames * config.init_decay_epoch
  cfg = config.render_settings("mono")
  t_cfg = config.train_settings()

  out_folder = config.out_folder()
  if is_main:
    os.makedirs(out_folder, exist_ok=True)
    with open(os.path.join(out_folder, "args.json"), "w") as fh:
      json.dump(vars(config), fh, indent=2, default=str)

  model = MonoModel(cfg, num_frames=data.num_frames, device=dev,
                    seed=INIT_SEED).train_all()
  opt = make_mono_optimizer(model, t_cfg)
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
                                      config.experiment_name()),
                         enabled=is_main)
  gen = torch.Generator(device=dev).manual_seed(STEP_SEED)
  global_step = start_step
  start_epoch = global_step // data.num_frames

  def batches(seed):
    return PrefetchPipeline(curriculum_sampler(data, config, start_epoch),
                            num_workers=config.workers, seed=seed,
                            device=dev)

  def phase_record(name, steps, t0, pipe, panel_s=()):
    _sync(dev)
    rec = {"steps": steps,
           "seconds": time.perf_counter() - t0 - sum(panel_s),
           "wait_s": pipe.wait_s, "panels": len(panel_s),
           "panel_s": float(sum(panel_s))}
    logger.scalars(global_step, rec, prefix=f"phase/{name}/")
    if is_main:
      print(f"[{config.expname}] {name}: " + " ".join(
          f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
          for k, v in rec.items()), flush=True)

  try:
    # ---- phase 1: static bootstrap (reference train.py:116-225) ----
    with batches(0) as pipe:
      t0, steps = time.perf_counter(), 0
      for epoch in range(start_epoch, config.init_decay_epoch // 2):
        for _ in range(data.num_frames):
          rb = next(pipe)
          _, metrics, _ = mono_train_step(model, opt, rb, None, cfg, t_cfg,
                                          bootstrap=True, generator=gen,
                                          mesh=mesh)
          global_step += 1
          steps += 1
          if global_step % config.i_print == 0:
            logger.scalars(global_step,
                           {k: float(v) for k, v in metrics.items()},
                           prefix="bootstrap/")
      phase_record("bootstrap", steps, t0, pipe)

    # ---- phase 2: main loop (reference train.py:227-573); a whole epoch
    # runs before the `while` test, as the JAX CLI's loop does ----
    with batches(1) as pipe:
      epoch = start_epoch
      t0 = t_print = time.perf_counter()
      steps, panel_s = 0, []
      while global_step < start_step + config.n_iters + 1:
        weights = schedule_weights(t_cfg, epoch)
        for _ in range(data.num_frames):
          rb = next(pipe)
          _, metrics, _ = mono_train_step(model, opt, rb, weights, cfg, t_cfg,
                                          generator=gen, mesh=mesh)
          global_step += 1
          steps += 1

          if global_step % config.i_print == 0:
            vals = {k: float(v) for k, v in metrics.items()}
            vals["steps_per_sec"] = config.i_print / (time.perf_counter()
                                                      - t_print)
            t_print = time.perf_counter()
            logger.scalars(global_step, vals, prefix="train/")
            if is_main:
              print(f"[{config.expname}] epoch {epoch} step {global_step} "
                    + " ".join(f"{k}={v:.5f}" for k, v in vals.items()),
                    flush=True)

          if global_step % config.i_weights == 0 and is_main:
            _save(out_folder, global_step, model, opt)
            print(f"saved checkpoint at {global_step}", flush=True)

          # rank 0 renders the panels alone, with no mesh: no rank waits
          # in a collective the others never join
          if global_step % config.i_img == 0 and is_main:
            _sync(dev)
            tp = time.perf_counter()
            frame_idx = int(rb["ref_frame_idx"])
            provider = getattr(data, "providers", [data])[0]
            try:
              gt_flows = np.stack([provider._load_flow(frame_idx, o)[0]
                                   for o in (1, 2, 3, -1, -2, -3)])
            except OSError:
              gt_flows = None
            log_train_view(logger, global_step, model, rb, cfg,
                           config.chunk_size, provider._load_rgb(frame_idx),
                           provider._load_disp(frame_idx), gt_flows=gt_flows)
            panel_s.append(time.perf_counter() - tp)

        # one-shot pre-virtual-view snapshot (reference train.py:503-506),
        # once per experiment folder
        if (is_main and epoch + 1 == config.init_decay_epoch * 5
            and ckpt_lib.latest_checkpoint(out_folder, NO_VV) is None):
          _save(out_folder, global_step, model, opt, name=NO_VV)
        epoch += 1
      phase_record("train", steps, t0, pipe, panel_s)

    if is_main:
      _save(out_folder, global_step, model, opt)
  finally:
    logger.close()
  return {"out_folder": out_folder, "start_step": start_step}


if __name__ == "__main__":
  main(sys.argv[1:])
