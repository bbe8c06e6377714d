"""Training traffic: a training CLI's step loop, step after step.

Mono configurations: ``train/trainer.mono_train_step`` fed by
``data/pipeline.PrefetchPipeline(cli/train.curriculum_sampler(...))`` over
the training dataset on a monocular scene written from the seed, as
``cli/train``'s phase-2 loop does at the traffic's ``epoch``: the
schedule's loss weights of that epoch, the anchor curriculum of that
epoch, no host sync inside the loop.  FF configurations:
``train/trainer.ff_train_step`` fed by the pipeline over
``NvidiaSceneData.sample_batch`` on an Nvidia-layout scene, with the
coarse stage frozen, as ``cli/train_ff`` does.

Set-up builds one model and optimizer from weights the benchmark makes,
drives them through ``check_steps`` steps (the window's own call and
feed) and keeps what the reference needs to follow them: each batch as
the pipeline handed it, the sample generator's state before each step,
each step's loss, the first gradient as Adam holds it after one step
(``exp_avg / (1 - beta1)``) and the parameters after the last check step.
``warm_steps`` more steps follow; then the window.  ``check`` frees the
program's state and runs the reference over the same batches from the
same weights (``portbench/checks/train.py``).

Traffic parameters: ``epoch``, ``workers``, ``check_steps``,
``warm_steps``, ``trace_units``.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict

import torch

from portbench.checks import train as train_check
from portbench.scenes.mono import MonoScene
from portbench.scenes.nvidia import NvidiaScene

# the program's step, called through this name (tests plant faults here)
STEP = None


def _program():
  from dynibar_tpu_torch.train import trainer
  return trainer


def _config(ctx, folder: str):
  from dynibar_tpu_torch.config import DynibarConfig
  settings = dict(ctx.cell.config["settings"])
  settings.update(folder_path=folder, train_scenes=["scene"],
                  workers=int(ctx.params.get("workers", 4)))
  return DynibarConfig(**settings)


def _seeds(seed: int) -> Dict[str, int]:
  """Independent streams from the one run seed."""
  return {"weights": seed % (2 ** 63), "scene": (seed * 7 + 1) % (2 ** 32),
          "pipeline": (seed * 13 + 5) % (2 ** 31 - 1),
          "sampling": (seed * 31 + 3) % (2 ** 63)}


def _is_ff(ctx) -> bool:
  return ctx.cell.config["model"] == "ff"


def setup(ctx) -> Dict[str, Any]:
  trainer = _program()
  from dynibar_tpu_torch.cli.train import curriculum_sampler
  from dynibar_tpu_torch.data.factory import create_training_dataset
  from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
  from dynibar_tpu_torch.data.pipeline import PrefetchPipeline
  from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel
  from dynibar_tpu_torch.train.losses import schedule_weights
  from portbench.reference import dynibar as ref_models
  from portbench.weights import make_weights

  ff = _is_ff(ctx)
  seeds = _seeds(ctx.seed)
  build_kernels(ctx)
  scene_cfg = ctx.cell.config["scene"]
  with ctx.span("scene_write"):
    t0 = time.perf_counter()
    scene = (NvidiaScene if ff else MonoScene)(
        seeds["scene"], scene_cfg["frames"], scene_cfg["height"],
        scene_cfg["width"], scene_cfg["focal"])
    wrote = scene.write(ctx.scratch, "scene")
    ctx.note(f"scene: wrote {wrote['bytes']} bytes in {wrote['files']} "
             f"files in {time.perf_counter() - t0:.3f} s")
  config = _config(ctx, ctx.scratch)
  epoch = int(ctx.params["epoch"])
  if ff:
    cfg = config.render_settings("ff_train")
    data = NvidiaSceneData(config, "scene", cfg=cfg,
                           height=config.training_height)
    data.set_epoch(epoch)

    def sample(np_rng, _):
      return data.sample_batch(np_rng, config.N_rand)
  else:
    data = create_training_dataset(config)
    cfg = config.render_settings("mono")
    sample = None
  config.num_frames = data.num_frames
  config.lrate_decay_steps = config.num_frames * config.init_decay_epoch
  tcfg = config.train_settings()
  dev = ctx.device

  ref_cls = ref_models.FFModel if ff else ref_models.MonoModel
  template = ref_cls(_ref_settings(cfg), data.num_frames, device="cpu")
  weights = make_weights(template, seeds["weights"], dev)
  del template
  if ff:
    model = FFModel(cfg, data.num_frames, device=dev).train_fine()
    model.load_state_dict(weights)
    opt = trainer.make_ff_optimizer(model, tcfg)
  else:
    model = MonoModel(cfg, num_frames=data.num_frames,
                      device=dev).train_all()
    model.load_state_dict(weights)
    opt = trainer.make_mono_optimizer(model, tcfg)
    sample = curriculum_sampler(data, config, epoch)
  gen = torch.Generator(device=dev).manual_seed(seeds["sampling"])
  loss_w = schedule_weights(tcfg, epoch)
  pipe = PrefetchPipeline(sample, num_workers=config.workers,
                          seed=seeds["pipeline"], device=dev)
  state = {"model": model, "opt": opt, "gen": gen, "pipe": pipe,
           "cfg": cfg, "tcfg": tcfg, "loss_w": loss_w, "scene": scene,
           "weights": {k: v.detach().cpu() for k, v in weights.items()},
           "num_frames": data.num_frames, "epoch": epoch, "config": config,
           "kind": "ff" if ff else "mono"}
  del weights
  step = STEP or default_step(ctx)
  rec = {"batches": [], "gen_states": [], "losses": []}
  with ctx.span("check_steps"):
    for k in range(int(ctx.params.get("check_steps", 3))):
      rb = next(pipe)
      rec["batches"].append({key: v.detach().cpu() for key, v in rb.items()})
      rec["gen_states"].append(gen.get_state())
      loss, _, _ = step(model, opt, rb, loss_w, cfg, tcfg, generator=gen)
      rec["losses"].append(float(loss))
      if k == 0:
        rec["grad1"] = train_check.program_first_grads(model, opt)
    rec["params"] = {n: p.detach().cpu().clone()
                     for n, p in model.named_parameters()}
  state["record"] = rec
  state["step"] = step
  with ctx.span("warm_steps"):
    for _ in range(int(ctx.params.get("warm_steps", 2))):
      step(model, opt, next(pipe), loss_w, cfg, tcfg, generator=gen)
  _sync(dev)
  return state


def build_kernels(ctx) -> None:
  """The kernel libraries the configuration's routes launch (the
  backward's only for traffic that trains), compiled in parallel where
  missing (the first run in a checkout); a warm run finds them all under
  build/kernels."""
  if ctx.device.type != "cuda":
    return
  from dynibar_tpu_torch.ops import build
  libs = ctx.cell.config["kernel_libraries"]
  names = libs["forward"] + (libs["backward"] if ctx.params.get("backward")
                             else [])
  with ctx.span("kernel_build"):
    t0 = time.perf_counter()
    done = build.build(names)
    if done:
      ctx.note(f"built {sorted(done)} in {time.perf_counter() - t0:.1f} s")


def _ref_settings(cfg):
  """The reference's settings: the cell's, computed in float32."""
  from portbench.reference.config import RenderSettings
  import dataclasses
  kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
  kw["compute_dtype"] = "float32"
  return RenderSettings(**kw)


def _sync(dev) -> None:
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


def window(state, ctx, seconds=None, units=None) -> Dict[str, Any]:
  """Steps until ``seconds`` have passed (or ``units`` steps), then a
  synchronize: step_s is the window's seconds over its steps."""
  step = state["step"]
  model, opt, pipe, gen = (state["model"], state["opt"], state["pipe"],
                           state["gen"])
  cfg, tcfg, loss_w = state["cfg"], state["tcfg"], state["loss_w"]
  _sync(ctx.device)
  wait0 = pipe.wait_s
  n = 0
  t0 = time.perf_counter()
  while True:
    with ctx.span("data"):
      rb = next(pipe)
    with ctx.span("step"):
      step(model, opt, rb, loss_w, cfg, tcfg, generator=gen)
    n += 1
    ctx.unit_done()
    if units is not None and n >= units:
      break
    if seconds is not None and time.perf_counter() - t0 >= seconds:
      break
  with ctx.span("sync"):
    _sync(ctx.device)
  t = time.perf_counter() - t0
  return {"units": n, "seconds": t, "step_s": t / n,
          "data_wait_s": pipe.wait_s - wait0}


def work(ctx, state) -> Dict[str, Any]:
  """The shapes of one step, for portbench/workcount.py, from the cell's
  configuration."""
  from portbench.workcount import mono_agg_calls
  conf = train_check.ref_config(ctx, state["num_frames"])
  r = int(conf.N_rand)
  h, w = ctx.cell.config["scene"]["height"], ctx.cell.config["scene"]["width"]
  if state["kind"] == "mono":
    cfg = conf.render_settings("mono")
    s, c = cfg.n_samples, 3 + cfg.coarse_feat_dim
    return {"agg": list(mono_agg_calls(r, s, cfg.num_views_dy,
                                       cfg.num_views_static,
                                       cfg.num_views_anchor, c, True)),
            "featnet": [(cfg.num_views_dy, h, w, True),
                        (cfg.num_views_anchor, h, w, True),
                        (cfg.num_views_static, h, w, True)],
            "motion": [(r * s, True), (r * s, True)]}
  # FF: the frozen coarse stage forward, the fine stage (and its anchor
  # branch) forward and backward
  cfg = conf.render_settings("ff_train")
  s0, s1 = cfg.n_samples, cfg.n_samples + cfg.n_importance
  c = 3 + cfg.coarse_feat_dim
  v_dy, v_st, v_a = (cfg.num_views_dy, cfg.num_views_static,
                     cfg.num_views_anchor)
  return {"agg": [(True, r, s0, v_st, c, False), (False, r, s0, v_dy, c, False),
                  (True, r, s1, v_st, c, True), (False, r, s1, v_dy, c, True),
                  (False, r, s1, v_a, c, True)],
          "featnet": [(v_dy + v_st, h, w, False),
                      (v_dy + v_a + v_st, h, w, True)],
          "motion": [(r * s0, False), (r * s1, True), (r * s1, True)]}


def close(state) -> None:
  pipe = state.get("pipe")
  if pipe is not None:
    pipe.close()


def _release(state, ctx):
  """Free the program's state; what the reference needs stays."""
  close(state)
  for key in ("model", "opt", "pipe", "gen"):
    state.pop(key, None)
  gc.collect()
  if ctx.device.type == "cuda":
    torch.cuda.empty_cache()


def check(state, ctx):
  """Free the program's state, then hold the recorded steps against the
  reference."""
  _release(state, ctx)
  return train_check.compare(ctx, state["record"], state["scene"],
                             state["weights"], state["num_frames"],
                             kind=state["kind"])


def default_step(ctx=None):
  trainer = _program()
  if ctx is not None and _is_ff(ctx):
    return trainer.ff_train_step
  return trainer.mono_train_step


def control_readings(state, ctx, control: bool):
  """The numbers of portbench/control.py for this set-up."""
  _release(state, ctx)
  return train_check.all_readings(ctx, state["record"], state["scene"],
                                  state["weights"], state["num_frames"],
                                  state["kind"], control=control)
