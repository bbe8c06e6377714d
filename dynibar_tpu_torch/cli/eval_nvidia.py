"""Nvidia benchmark eval CLI.

Port of ``dynibar_tpu.cli.eval_nvidia`` (reference eval_nvidia.py:266-481):
for each scene of ``eval_scenes``, the whole protocol of
``eval/nvidia_eval.evaluate_scene``, its per-scene JSON and, for more
than one scene, the cross-scene mean table.

    python -m dynibar_tpu_torch.cli.eval_nvidia \\
        --config configs_nvidia/eval_balloon1_long.txt \\
        [--coarse_ckpt coarse.pth --fine_ckpt fine.pth] [--device cpu]

Weights come from a google/dynibar ``.pth`` pair (``--coarse_ckpt`` and
``--fine_ckpt``), else from the newest snapshot in the experiment folder
(or ``ckpt_path``), else a random init from a seed, with a WARNING.
``--lpips_weights_dir`` holds ``alex.pth`` and ``alexnet.pth``; without
them LPIPS is NaN.  ``--max_frames N`` evaluates the first N frames,
``--results_json`` writes the results, and every other ``--key value``
sets that field of ``DynibarConfig``.  ``--device cpu`` runs the plain
PyTorch twins on the CPU; without it the CLI needs the CUDA card.  Under
``torchrun`` (one process per card, ``parallel/mesh.py``) every rank
renders its share of each viewpoint's rays; rank 0 scores the frames,
prints the tables and writes the JSON, and the other ranks return {}.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from dynibar_tpu_torch.cli.train import parse_args
from dynibar_tpu_torch.config import INIT_SEED
from dynibar_tpu_torch.data.nvidia import NvidiaSceneData
from dynibar_tpu_torch.eval.nvidia_eval import evaluate_scene
from dynibar_tpu_torch.models.dynibar import FFModel
from dynibar_tpu_torch.parallel.mesh import replicate, training_mesh
from dynibar_tpu_torch.utils import checkpoints as ckpt_lib
from dynibar_tpu_torch.utils.convert import load_reference_ff_checkpoint
from dynibar_tpu_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
  """Run the CLI; returns {scene: {region: {metric: value}}} (and "mean"
  for more than one scene); {} on mesh ranks other than 0."""
  ap = argparse.ArgumentParser(add_help=False)
  ap.add_argument("--coarse_ckpt", type=str, default="")
  ap.add_argument("--fine_ckpt", type=str, default="")
  ap.add_argument("--lpips_weights_dir", type=str, default="")
  ap.add_argument("--results_json", type=str, default="")
  ap.add_argument("--max_frames", type=int, default=0,
                  help="evaluate only the first N frames (0 = all)")
  known, _ = ap.parse_known_args(argv)
  config, device = parse_args(argv)

  if not config.eval_scenes:
    raise SystemExit("error: no eval scene: pass --eval_scenes <scene...> "
                     "or a --config with `eval_scenes = ...`")
  mesh = training_mesh(config, device)
  dev = mesh.device if mesh is not None else resolve_device(device)
  is_main = mesh is None or mesh.is_main
  say = print if is_main else (lambda *a, **kw: None)

  all_results = {}
  for scene in config.eval_scenes:
    data = NvidiaSceneData(config, scene, height=config.training_height)
    config.num_frames = data.num_frames
    cfg = config.render_settings("ff")
    model = FFModel(cfg, num_frames=data.num_frames, device=dev,
                    seed=INIT_SEED)

    if known.coarse_ckpt and known.fine_ckpt:
      load_reference_ff_checkpoint(model, known.coarse_ckpt, known.fine_ckpt)
      say("loaded the reference torch checkpoints")
    else:
      payload, step = ckpt_lib.resume_from(config.out_folder(),
                                           config.ckpt_path,
                                           map_location=dev)
      if payload is not None:
        model.load_state_dict(payload["model"])
        say(f"resumed the checkpoint at step {step}")
      else:
        say("WARNING: no checkpoint found — evaluating random init")
    if mesh is not None:
      replicate(mesh, model)

    frame_range = (range(3, min(3 + known.max_frames, data.num_frames - 3))
                   if known.max_frames else None)
    result = evaluate_scene(
        config, model, scene,
        lpips_weights_dir=known.lpips_weights_dir or None,
        frame_range=frame_range, device=dev, mesh=mesh)
    if not is_main:
      continue
    all_results[scene] = result
    print(f"[{scene}] {json.dumps(result)}")
  if not is_main:
    return {}

  # cross-scene means (the paper-table aggregation)
  if len(all_results) > 1:
    all_results["mean"] = {
        region: {m: float(sum(r[region][m] for r in all_results.values())
                          / len(all_results))
                 for m in ("psnr", "ssim", "lpips")}
        for region in ("full", "dynamic", "static")}
  print(json.dumps(all_results, indent=2))
  if known.results_json:
    with open(known.results_json, "w") as fh:
      json.dump(all_results, fh, indent=2)
    print(f"wrote {known.results_json}")
  return all_results


if __name__ == "__main__":
  main()
