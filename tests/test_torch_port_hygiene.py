"""Package rules of the PyTorch/CUDA port:

  * no module of dynibar_tpu_torch (and not chip_smoke.py, nor the port's
    scripts, scripts/port_*.py and scripts/data_pipeline_cost.py) imports
    jax, flax, optax, orbax or
    anything of dynibar_tpu, checked statically and
    by importing every module in a subprocess with those names blocked
    (this pytest process has imported JAX already), and with cv2, imageio,
    PIL and skimage blocked too: the machine with the card has none of
    them;
  * the host decoder's C++ source (csrc/image_loader.cc) includes the C++
    standard library's headers only: it builds on a machine with no
    image, compression or other third-party library;
  * kernel wrappers given CPU tensors take the plain twins;
  * entry points called without device="cpu" on a host without CUDA raise,
    and chip_smoke.py exits non-zero without printing a result.
"""

import ast
import pathlib
import re
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
from torch_port_threads import one_torch_thread  # noqa: F401

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
               "parallel/mesh.py", "data/native_loader.py",
               "data/flow_io.py")
# image and video libraries the card's machine lacks: no module may need
# one to import (serve/video.py imports cv2 only to encode an mp4)
ABSENT_ON_CARD = ("cv2", "imageio", "PIL", "skimage")


# the port's scripts: each imports only dynibar_tpu_torch, numpy, torch
# and the standard library
PORT_SCRIPTS = ("port_eval_ff_synthetic.py", "port_ff_convergence.py",
                "port_mono_convergence.py", "port_pipeline_ab.py",
                "port_profile.py")


# the port's host C++ sources (built by ops/build.load_host)
HOST_SOURCES = ("csrc/image_loader.cc",)
# what a host source may include: the C++ standard library's headers
STD_HEADERS = {
    "algorithm", "array", "atomic", "cerrno", "chrono", "cmath",
    "condition_variable", "cstddef", "cstdint", "cstdio", "cstdlib",
    "cstring", "functional", "limits", "memory", "mutex", "queue",
    "stdexcept", "string", "thread", "utility", "vector"}


def _sources():
  return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
          + sorted((ROOT / "scripts").glob("port_*.py"))
          + [ROOT / "scripts" / "data_pipeline_cost.py"])


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
  eval/, serve/ and parallel/ included, the data path's modules and the
  port's scripts."""
  scanned = {p.parent for p in _sources()}
  packages = {p.parent for p in PKG.rglob("__init__.py")}
  assert packages <= scanned
  assert {PKG / "train", PKG / "cli", PKG / "eval", PKG / "serve",
          PKG / "parallel"} <= packages
  names = {p.relative_to(PKG).as_posix() for p in _sources() if PKG in
           p.parents}
  assert set(NEW_MODULES) <= names
  scripts = {p.name for p in _sources() if p.parent == ROOT / "scripts"}
  assert set(PORT_SCRIPTS) <= scripts


@pytest.mark.parametrize("name", HOST_SOURCES)
def test_host_sources_include_the_standard_library_only(name):
  """No third-party header (png.h, jpeglib.h, zlib.h, ...): the card's
  machine promises none, and ops/build.py links nothing but libstdc++ and
  pthreads."""
  text = (PKG / name).read_text()
  included = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", text,
                        re.MULTILINE)
  assert included and set(included) <= STD_HEADERS, sorted(
      set(included) - STD_HEADERS)
  assert sorted(p.relative_to(PKG).as_posix()
                for p in (PKG / "csrc").glob("*.cc")) == sorted(HOST_SOURCES)


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
