"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``build/kernels/<name>-<hash>.so`` at the repository
root, listed in .gitignore).  The hash covers the sources and the flags,
so an edited kernel never loads a stale library.  Nothing here runs at
import time: the first launch builds, or a caller builds ahead with
:func:`build` (which starts one nvcc per source, all at once).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("sample", "static_agg", "dynamic_agg")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc"), shutil.which("nvcc")):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                     "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
  digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for src in sorted(CSRC.glob("*.cu*")):
    if src.suffix == ".cuh" or src.stem == name:
      digest.update(src.read_bytes())
  return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
  """Compile every missing library in parallel; return seconds per name.

  The compiler's output (with ``-Xptxas -v``: registers, shared memory
  and spills per kernel) is kept beside each library as ``.log``."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  t0 = time.perf_counter()
  for name in names:
    out = library_path(name)
    if out.exists():
      continue
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = open(out.with_suffix(".log"), "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                   tmp, out, log)
  seconds = {}
  for name, (proc, tmp, out, log) in procs.items():
    rc = proc.wait()
    log.close()
    seconds[name] = time.perf_counter() - t0
    if rc != 0:
      raise RuntimeError(f"nvcc failed for {name} (rc {rc}):\n"
                         + out.with_suffix(".log").read_text()[-4000:])
    os.replace(tmp, out)
  return seconds


def load(name: str) -> ctypes.CDLL:
  """The loaded library of csrc/<name>.cu, built on first use."""
  if name not in _LIBS:
    path = library_path(name)
    if not path.exists():
      build([name])
    _LIBS[name] = ctypes.CDLL(str(path))
  return _LIBS[name]


def check(err: int, what: str) -> None:
  """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
  if err != 0:
    raise RuntimeError(f"{what}: CUDA error {err}")
