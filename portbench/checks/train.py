"""What decides ``correct`` in a training cell.

The program's first ``check_steps`` steps (run in set-up through the
window's own call and feed) against the plain reference following the
same steps from the same weights, batches and sample draws:

* ``batch_max_abs``: the data stage on its own.  Every field of each kept
  mono batch (pixels, rays, cameras, times, disparity, masks, flows, the
  temporal, virtual, anchor and static sources) worked out again from
  the scene's arrays, given the draws the pipeline made, which are held
  to their rules (``portbench/checks/batch.py``; exact: limit 0).  The
  reference then takes the batch as the pipeline made it, and works out
  everything else again: weights, feature maps, samples, renders,
  losses, gradients, Adam.
* ``loss_rel``: the largest relative gap between the program's and the
  reference's loss over the check steps.
* ``grad_rel``: by the worst leaf, the gap between the norms of the
  program's first gradient (from Adam's state after one step) and the
  reference's, over the larger of that leaf's reference norm and the
  median leaf's.
* ``update_rel``: the same for the parameters' change over the check
  steps.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's move under Adam by round-off alone: they are left out of
``grad_rel`` and ``update_rel`` by that rule, not by name.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List

import numpy as np
import torch

EXCLUDE_BELOW = 1e-3


def program_first_grads(model, opt) -> Dict[str, float]:
  """Each leaf's first-gradient norm as Adam holds it after one step."""
  beta1 = opt.param_groups[0]["betas"][0]
  out = {}
  for name, p in model.named_parameters():
    st = opt.state.get(p)
    if st and "exp_avg" in st:
      out[name] = float(torch.linalg.vector_norm(st["exp_avg"].float())
                        / (1.0 - beta1))
  return out


def batch_gaps(ctx, rec, scene, kind: str) -> Dict[str, float]:
  """Each batch field's largest gap against the scene: every field of a
  mono batch (``portbench/checks/batch.py``); of an FF batch the target
  pixels and the temporal source frames (offsets -3..3)."""
  if kind == "mono":
    from portbench.checks.batch import mono_batch_gaps
    return mono_batch_gaps(rec["batches"], scene, ctx.cell.config["settings"],
                           int(ctx.params["epoch"]))
  worst = 0.0
  temporal = 6 if kind == "mono" else 7
  for rb in rec["batches"]:
    idx = int(rb["ref_frame_idx"])
    img = scene.frame8(idx).astype(np.float32) / 255.0
    uv = rb["uv_grid"].numpy().astype(np.int64)
    want = img[uv[:, 1], uv[:, 0]]
    worst = max(worst, float(np.abs(rb["rgb"].numpy() - want).max()))
    offs = rb["src_offset_idx"].numpy() - 3
    for j in range(temporal):
      src = scene.frame8(idx + int(offs[j])).astype(np.float32) / 255.0
      worst = max(worst, float(np.abs(rb["src_rgbs"][j].numpy() - src).max()))
  return {"pixels": worst}


def ref_config(ctx, num_frames: int):
  """The reference's settings, worked out from the cell's configuration
  file, in float32."""
  from portbench.reference.config import DynibarConfig
  settings = dict(ctx.cell.config["settings"])
  settings["compute_dtype"] = "float32"
  cfg = DynibarConfig(**settings)
  cfg.num_frames = num_frames
  cfg.lrate_decay_steps = num_frames * cfg.init_decay_epoch
  return cfg


def reference_run(ctx, rec, weights, num_frames: int, kind: str,
                  fp8: bool = False) -> Dict[str, Any]:
  """The reference's check steps: losses, first-gradient norms, the
  parameters' change by leaf."""
  from portbench.reference import dynibar as models
  from portbench.reference import precision
  from portbench.reference.losses import schedule_weights
  from portbench.reference.train_step import ReferenceTrainer
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = ctx.device
  cfg = ref_config(ctx, num_frames)
  tcfg = cfg.train_settings()
  mode = "mono" if kind == "mono" else "ff_train"
  rcfg = cfg.render_settings(mode)
  if kind == "mono":
    model = models.MonoModel(rcfg, num_frames, device=dev).train_all()
  else:
    model = models.FFModel(rcfg, num_frames, device=dev).train_fine()
  model.load_state_dict({k: v.to(dev) for k, v in weights.items()})
  trainer = ReferenceTrainer(model, rcfg, tcfg, kind)
  loss_w = schedule_weights(tcfg, int(ctx.params["epoch"]))
  gen = torch.Generator(device=dev)
  names = {id(p): n for n, p in model.named_parameters()}
  losses, grads = [], {}
  precision.set_fp8(fp8)
  try:
    for k, rb in enumerate(rec["batches"]):
      gen.set_state(rec["gen_states"][k])
      rb_dev = {key: v.to(dev) for key, v in rb.items()}
      loss, g = trainer.step(rb_dev, loss_w, gen,
                             chunks=int(ctx.params.get("reference_chunks", 1)))
      losses.append(loss)
      if k == 0:
        grads = {names[i]: (0.0 if v is None
                            else float(torch.linalg.vector_norm(v)))
                 for i, v in g.items()}
      del rb_dev, g
  finally:
    precision.set_fp8(False)
  after = {n: p.detach().cpu() for n, p in model.named_parameters()}
  del model, trainer
  if dev.type == "cuda":
    torch.cuda.empty_cache()
  return {"losses": losses, "grad1": grads, "params": after}


def _leaf_gaps(a: Dict[str, float], b: Dict[str, float], keep: List[str],
               scale: Dict[str, float]) -> Dict[str, float]:
  med = statistics.median(scale[n] for n in keep)
  return {n: abs(a.get(n, 0.0) - b[n]) / max(scale[n], med) for n in keep}


def _worst(gaps: Dict[str, float], k: int = 3):
  return sorted(gaps.items(), key=lambda kv: -kv[1])[:k]


def readings(side: Dict[str, Any], ref: Dict[str, Any],
             weights: Dict[str, torch.Tensor]) -> Dict[str, float]:
  """The three numbers of one side (program or control) against the
  reference."""
  gr = ref["grad1"]
  med = statistics.median(gr.values())
  keep = [n for n, v in gr.items() if v >= EXCLUDE_BELOW * med]
  loss_rel = max(abs(a - b) / abs(b)
                 for a, b in zip(side["losses"], ref["losses"]))
  g_gaps = _leaf_gaps(side["grad1"], gr, keep, gr)

  def change(params):
    return {n: float(torch.linalg.vector_norm(params[n].float()
                                              - weights[n].float()))
            for n in keep}
  d_ref = change(ref["params"])
  u_gaps = _leaf_gaps(change(side["params"]), d_ref, keep, d_ref)
  return {"loss_rel": loss_rel, "grad_rel": max(g_gaps.values()),
          "update_rel": max(u_gaps.values()), "leaves_kept": len(keep),
          "leaves": len(gr), "grad_worst": _worst(g_gaps),
          "update_worst": _worst(u_gaps),
          "grad_median": statistics.median(g_gaps.values()),
          "update_median": statistics.median(u_gaps.values())}


def all_readings(ctx, rec, scene, weights, num_frames: int, kind: str,
                 control: bool = False) -> Dict[str, Any]:
  """The batch gap, the program's readings and (``control``) the fp8
  control's, each against the float32 reference."""
  gaps = batch_gaps(ctx, rec, scene, kind)
  ref = reference_run(ctx, rec, weights, num_frames, kind)
  prog = {"losses": rec["losses"], "grad1": rec["grad1"],
          "params": rec["params"]}
  out = {"batch_max_abs": max(gaps.values()), "batch_gaps": gaps,
         "program": readings(prog, ref, weights),
         "losses": {"program": rec["losses"], "reference": ref["losses"]}}
  if control:
    ctrl = reference_run(ctx, rec, weights, num_frames, kind, fp8=True)
    ctrl_side = {"losses": ctrl["losses"], "grad1": ctrl["grad1"],
                 "params": ctrl["params"]}
    out["control"] = readings(ctrl_side, ref, weights)
  return out


def judged(ctx, readings: Dict[str, Any]) -> List[Dict[str, Any]]:
  """The numbers the cell's workload file gives a limit, each against it;
  the others are printed for the record and judge nothing."""
  limits = ctx.cell.workload["limits"]
  rest = {k: v for k, v in readings.items() if k not in limits}
  ctx.note(f"readings not judged: {rest}")
  return [{"name": k, "value": readings[k], "limit": lim,
           "ok": bool(readings[k] <= lim)} for k, lim in limits.items()]


def compare(ctx, rec, scene, weights, num_frames: int, kind: str
            ) -> List[Dict[str, Any]]:
  r_all = all_readings(ctx, rec, scene, weights, num_frames, kind)
  ctx.note(f"losses {r_all['losses']}; batch gaps {r_all['batch_gaps']}")
  return judged(ctx, dict(r_all["program"],
                          batch_max_abs=r_all["batch_max_abs"]))
