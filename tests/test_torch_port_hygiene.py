"""Package rules of the PyTorch/CUDA port:

  * no module of dynibar_tpu_torch (and not chip_smoke.py) imports jax,
    flax, optax, orbax or anything of dynibar_tpu, checked statically and
    by importing every module in a subprocess with those names blocked
    (this pytest process has imported JAX already), and with cv2, imageio,
    PIL and skimage blocked too: the machine with the card has none of
    them;
  * kernel wrappers given CPU tensors take the plain twins;
  * entry points called without device="cpu" on a host without CUDA raise,
    and chip_smoke.py exits non-zero without printing a result.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.data.ray_batch import synthetic_ff_batch
from dynibar_tpu_torch.models.dynibar import FFModel
from dynibar_tpu_torch.ops import agg, sample
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_ff)
from dynibar_tpu_torch.render.render_rays import render_rays_mv

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dynibar_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "dynibar_tpu")
CFG = RenderSettings(n_samples=4, n_importance=4, num_views_dy=7,
                     num_views_static=3, inv_uniform=True)
# the training, eval and preprocessing CLIs' modules: each must import with
# JAX blocked
NEW_MODULES = ("cli/train.py", "data/png.py", "data/llff.py",
               "data/view_selection.py", "data/monocular.py",
               "data/factory.py", "data/pipeline.py",
               "data/synthetic_scene.py", "utils/checkpoints.py",
               "utils/logging.py", "utils/viz.py", "train/view_logging.py",
               "cli/eval_nvidia.py", "data/jpeg.py", "data/resize.py",
               "data/nvidia.py", "eval/metrics.py", "eval/lpips.py",
               "eval/nvidia_eval.py", "cli/render_monocular.py",
               "serve/video.py", "serve/session.py", "serve/registry.py",
               "serve/server.py", "cli/train_ff.py", "eval/held_out.py",
               "ops/splat.py", "cli/save_monocular_cameras.py",
               "cli/render_source_vv.py", "utils/profiling.py",
               "parallel/mesh.py")
# image and video libraries the card's machine lacks: no module may need
# one to import (serve/video.py imports cv2 only to encode an mp4)
ABSENT_ON_CARD = ("cv2", "imageio", "PIL", "skimage")


def _sources():
  return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module.split(".")[0]


def test_scan_covers_every_subpackage():
  """The static scan reaches every package directory, train/, cli/,
  eval/, serve/ and parallel/ included, and the data path's modules."""
  scanned = {p.parent for p in _sources()}
  packages = {p.parent for p in PKG.rglob("__init__.py")}
  assert packages <= scanned
  assert {PKG / "train", PKG / "cli", PKG / "eval", PKG / "serve",
          PKG / "parallel"} <= packages
  names = {p.relative_to(PKG).as_posix() for p in _sources() if PKG in
           p.parents}
  assert set(NEW_MODULES) <= names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
  bad = sorted(set(_imported_roots(path)) & set(BANNED))
  assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_BLOCKED_IMPORT = """
import importlib, importlib.abc, pkgutil, sys
BANNED = {banned!r}
class Block(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.split(".")[0] in BANNED:
      raise ImportError("blocked: " + name)
    return None
sys.meta_path.insert(0, Block())
import dynibar_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dynibar_tpu_torch.__path__,
                                               "dynibar_tpu_torch.")]
for name in names:
  importlib.import_module(name)
import chip_smoke
assert not any(m.split(".")[0] in BANNED for m in sys.modules)
print(" ".join(names))
"""


def test_package_imports_with_jax_blocked():
  out = subprocess.run(
      [sys.executable, "-c",
       _BLOCKED_IMPORT.format(banned=BANNED + ABSENT_ON_CARD)],
      cwd=ROOT, capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr[-2000:]
  names = set(out.stdout.split())
  assert len(names) >= 30
  assert {"dynibar_tpu_torch." + m[:-3].replace("/", ".")
          for m in NEW_MODULES} <= names


def test_render_on_cpu_launches_no_kernel():
  model = FFModel(CFG, 48, device="cpu")
  rb = synthetic_ff_batch(CFG, n_rays=6, h=16, w=24)
  with torch.no_grad():
    c, f = model.encode_featmaps(torch.from_numpy(rb["src_rgbs"]),
                                 torch.from_numpy(rb["static_src_rgbs"]))
  counters = (sample.sample_views, agg.fused_static_aggregator,
              agg.fused_dynamic_aggregator)
  before = [fn.launches for fn in counters]
  ret = render_rays_mv(model, rb, c, f, CFG, device="cpu")
  assert [fn.launches for fn in counters] == before
  assert torch.isfinite(ret["outputs_fine_ref"]["rgb"]).all()


def test_entry_points_need_cuda_or_cpu():
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    FFModel(CFG, 48)
  model = FFModel(CFG, 48, device="cpu")
  rb = synthetic_ff_batch(CFG, n_rays=2, h=16, w=24)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    render_rays_mv(model, rb, None, None, CFG)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    full_image_ray_batch(rb, rb["camera"])
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    render_image_ff(model, rb, None, None, CFG, 4, 1, 2)


def test_chip_smoke_fails_without_cuda(tmp_path):
  """Non-zero and no result line, from the repository and from a directory
  that holds chip_smoke.py and nothing else."""
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA")
  alone = tmp_path / "chip_smoke.py"
  alone.write_text((ROOT / "chip_smoke.py").read_text())
  for script in (ROOT / "chip_smoke.py", alone):
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
