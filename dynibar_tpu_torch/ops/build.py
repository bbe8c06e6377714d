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

The host decoder (``csrc/image_loader.cc``, C++ for the CPU) builds the
same way with the host C++ compiler (``$CXX``, else ``g++``) into
``build/host/``, at its first use (:func:`load_host`), under a file lock so
that processes starting together compile it once.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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

# no -march: the resize rounds alike on every host; no contraction into
# fused multiply-adds, which aarch64 hosts would otherwise make
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
              "-ffp-contract=off")
HOST_DIR = BUILD_DIR.parent / "host"

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


def _cxx() -> str:
  cxx = os.environ.get("CXX") or "g++"
  found = shutil.which(cxx)
  if found is None:
    raise RuntimeError(f"{cxx} not found: the host decoder "
                       "(csrc/image_loader.cc) builds with the host C++ "
                       "compiler ($CXX, else g++)")
  return found


def host_library_path(name: str) -> Path:
  """build/host/<name>-<hash>.so: the hash covers csrc/<name>.cc, the
  compiler and the flags (and none of the CUDA sources)."""
  digest = hashlib.sha256(" ".join((_cxx(),) + HOST_FLAGS).encode())
  digest.update((CSRC / f"{name}.cc").read_bytes())
  return HOST_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _file_lock(path: Path):
  with open(path, "w") as fh:
    fcntl.flock(fh, fcntl.LOCK_EX)
    try:
      yield
    finally:
      fcntl.flock(fh, fcntl.LOCK_UN)


def build_host(name: str) -> float:
  """Compile csrc/<name>.cc for the host unless it is built; return the
  seconds spent (0.0 if it was).  Raises with the compiler's output."""
  out = host_library_path(name)
  if out.exists():
    return 0.0
  HOST_DIR.mkdir(parents=True, exist_ok=True)
  t0 = time.perf_counter()
  with _file_lock(HOST_DIR / f"{name}.lock"):
    if out.exists():                  # another process built it meanwhile
      return time.perf_counter() - t0
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([_cxx(), *HOST_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cc")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
      raise RuntimeError(f"{_cxx()} failed for {name}.cc (rc "
                         f"{proc.returncode}):\n"
                         + (proc.stdout + proc.stderr)[-4000:])
    os.replace(tmp, out)
  return time.perf_counter() - t0


def load_host(name: str) -> ctypes.CDLL:
  """The loaded host library of csrc/<name>.cc, built on first use."""
  key = f"host:{name}"
  lib = _LIBS.get(key)
  if lib is not None:
    return lib
  with _LOAD_LOCK:
    if key not in _LIBS:
      build_host(name)
      _LIBS[key] = ctypes.CDLL(str(host_library_path(name)))
    return _LIBS[key]
