"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``build/kernels/<name>-<hash>.so`` at the repository
root, listed in .gitignore).  The hash covers the sources and the flags,
so an edited kernel never loads a stale library.  Nothing here runs at
import time: the first launch builds, or a caller builds ahead with
:func:`build` (which starts one nvcc per source, all at once).

A library named in :func:`use_phase_clocks` loads from its phase-clock
build instead (``PHASE_FLAGS``, ``<name>-phases-<hash>.so``): the same
sources with per-phase clock64 sums compiled in (csrc/phase_clock.cuh),
for ``scripts/port_profile.py --phases`` only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Set, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PHASE_FLAGS = ("-DAGG_PHASE_CLOCKS",)
KERNEL_SOURCES = ("sample", "static_agg", "dynamic_agg", "static_agg_bwd",
                  "static_agg_bwd3", "dynamic_agg_bwd", "dynamic_agg_bwd1")

_LIBS: Dict[str, ctypes.CDLL] = {}
_PHASES: Set[str] = set()
# the server's handler threads may make a kernel's first launch at once
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
  for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc"), shutil.which("nvcc")):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                     "machine with the CUDA toolkit")


def use_phase_clocks(names: Iterable[str]) -> None:
  """Load these libraries from their phase-clock build."""
  for name in names:
    _PHASES.add(name)
    _LIBS.pop(name, None)


def library_path(name: str, phases: bool = False) -> Path:
  flags = NVCC_FLAGS + (PHASE_FLAGS if phases else ())
  digest = hashlib.sha256(" ".join(flags).encode())
  for src in sorted(CSRC.glob("*.cu*")):
    if src.suffix == ".cuh" or src.stem == name:
      digest.update(src.read_bytes())
  tag = "-phases" if phases else ""
  return BUILD_DIR / f"{name}{tag}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES,
          phases: bool = False) -> Dict[str, float]:
  """Compile every missing library in parallel (their phase-clock builds
  if `phases`); return seconds per name."""
  return {name: sec for (name, _), sec in
          build_jobs([(n, phases) for n in names]).items()}


def build_jobs(jobs: Iterable[Tuple[str, bool]]
               ) -> Dict[Tuple[str, bool], float]:
  """Compile every missing (name, phases) build at once, one nvcc each;
  return seconds per job.

  The compiler's output (with ``-Xptxas -v``: registers, shared memory
  and spills per kernel) is kept beside each library as ``.log``."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  t0 = time.perf_counter()
  for job in jobs:
    name, phases = job
    out = library_path(name, phases)
    if out.exists():
      continue
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = open(out.with_suffix(".log"), "w")
    cmd = [_nvcc(), *NVCC_FLAGS, *(PHASE_FLAGS if phases else ()), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    procs[job] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                  tmp, out, log)
  seconds = {}
  for job, (proc, tmp, out, log) in procs.items():
    rc = proc.wait()
    log.close()
    seconds[job] = time.perf_counter() - t0
    if rc != 0:
      raise RuntimeError(f"nvcc failed for {job[0]} (rc {rc}):\n"
                         + out.with_suffix(".log").read_text()[-4000:])
    os.replace(tmp, out)
  return seconds


def load(name: str) -> ctypes.CDLL:
  """The loaded library of csrc/<name>.cu, built on first use."""
  lib = _LIBS.get(name)
  if lib is not None:
    return lib
  with _LOAD_LOCK:
    if name not in _LIBS:
      phases = name in _PHASES
      path = library_path(name, phases)
      if not path.exists():
        build([name], phases)
      _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def check(err: int, what: str) -> None:
  """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
  if err != 0:
    raise RuntimeError(f"{what}: CUDA error {err}")
