"""The mesh: one process per card over ``torch.distributed``.

Port of ``dynibar_tpu.parallel.mesh``.  The JAX package drives every chip
from one controller through a 1-D mesh whose ``data`` axis shards the ray
dimension; XLA inserts the gradient all-reduce.  Here ``torchrun``
(``python -m torch.distributed.run``) starts one process per card, each
rank holds the whole model and renders its rows of the rays, and the
collectives are explicit.  They are the three that NCCL and gloo both
take: ``all_reduce`` (SUM), ``broadcast`` and ``all_gather`` (on gloo
through the host, where the outputs go anyway).

What keeps a sharded training step equal to one card's:

  * every rank draws the same global batch (``N_rand`` rays; the data
    pipeline's order is deterministic) and keeps its rows
    (:func:`shard_ray_batch`);
  * every ratio term of the loss is a local numerator over a global
    denominator, from one all-reduce of the stacked, detached
    denominators, and every mean over rays divides by the global count
    (``train/losses.py``), so the ranks' losses sum to the one-card loss;
  * each rank keeps its rows of the global draw of the sample placement's
    uniforms (``core/sampling.RowShard``);
  * one all-reduce (SUM) of the flat gradients, with the step's metrics in
    the same buffer (:func:`sum_gradients`), before the norm, the clip and
    Adam: every rank applies the same update.

Frame renders shard the frame's rays in contiguous shares, one per rank,
and gather them to rank 0 (``render/render_image.py``).
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import threading
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from dynibar_tpu_torch.utils.device import DeviceLike, resolve_device

# keys whose leading axis is the ray axis
RAY_SHARDED_KEYS = ("ray_o", "ray_d", "uv_grid", "rgb", "disp", "motion_mask",
                    "static_mask")
# keys whose *second* axis is the ray axis
RAY_SHARDED_AXIS1_KEYS = ("flows", "flow_masks")
# the server's followers wait for the next request on this group: an idle
# server must not trip the default group's watchdog
HEADER_TIMEOUT = datetime.timedelta(days=30)
LAUNCH_HINT = ("python -m torch.distributed.run --nproc_per_node <cards> "
               "-m dynibar_tpu_torch.cli.<entry point> ...")


@dataclasses.dataclass
class Mesh:
  """This process's place in the mesh: its rank, the world size, its
  device, the backend of the default process group, a gloo group for
  the server's request headers, and the lock that keeps the threads of
  one process from running two sharded renders' collectives at once (the
  ranks must enter every collective in the same order)."""

  rank: int
  world: int
  device: torch.device
  backend: str
  header_group: Any = None
  lock: Any = dataclasses.field(default_factory=threading.Lock, repr=False)

  @property
  def is_main(self) -> bool:
    return self.rank == 0

  def rows(self, n: int) -> slice:
    """This rank's rows of an axis of ``n`` rays, split evenly."""
    if n % self.world:
      raise ValueError(f"N_rand={n} must be divisible by the mesh size "
                       f"{self.world}")
    k = n // self.world
    return slice(self.rank * k, (self.rank + 1) * k)

  def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t

  def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t

  def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    dist.broadcast(t, src)
    return t

  def gather_rows(self, t: torch.Tensor) -> Optional[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) concatenated along axis 0 in rank
    order, on rank 0; None on the others.  gloo gathers on the host."""
    if self.backend == "gloo":
      t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(self.world)]
    dist.all_gather(parts, t)
    return torch.cat(parts) if self.is_main else None

  def broadcast_header(self, t: torch.Tensor) -> torch.Tensor:
    """Broadcast a host tensor from rank 0 on the header group."""
    dist.broadcast(t, 0, group=self.header_group)
    return t


_MESH: Optional[Mesh] = None


def _launched(init_method: Optional[str]) -> bool:
  return (init_method is not None or dist.is_initialized()
          or "WORLD_SIZE" in os.environ)


def training_mesh(config, device: DeviceLike = None, *,
                  init_method: Optional[str] = None,
                  rank: Optional[int] = None,
                  world_size: Optional[int] = None) -> Optional[Mesh]:
  """The mesh of the entry points (training, eval, render, serving).

  Under ``torchrun`` the ranks initialise from the environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``; each rank's card is set current before
  the init); a caller may pass ``init_method`` (a ``file://`` store),
  ``rank`` and ``world_size`` instead.  ``config.mesh_shape`` "auto" is
  the launcher's world size and "N" must equal it.  Outside a launcher,
  "auto" and "1" return None (the one-card path) and a larger mesh
  raises.  A multi-node ``torchrun`` takes the same path: its environment
  says so, as it does for one node.  Under a launcher a world of 1
  still builds the mesh.  A second call in the same process returns the
  same mesh.

  The backend is NCCL when each rank has a card of its own, gloo on the
  CPU (``device="cpu"``) and for ranks that share one card.  A failed
  init raises: there is no fallback."""
  global _MESH
  spec = str(getattr(config, "mesh_shape", "auto")).strip()
  if not _launched(init_method):
    if spec in ("auto", "", "1"):
      return None
    raise RuntimeError(f"mesh_shape={spec!r}: a mesh runs one process per "
                       f"card under torchrun ({LAUNCH_HINT})")
  if dist.is_initialized():
    world = dist.get_world_size()
  else:
    world = int(world_size if world_size is not None
                else os.environ["WORLD_SIZE"])
  if spec not in ("auto", "") and int(spec) != world:
    raise ValueError(f"mesh_shape={spec} but the launcher started {world} "
                     "processes")
  if _MESH is None:
    _MESH = _init(device, init_method, rank, world)
  return _MESH


def _init(device: DeviceLike, init_method: Optional[str],
          rank: Optional[int], world: int) -> Mesh:
  if dist.is_initialized():
    rank = dist.get_rank()
  elif rank is None:
    rank = int(os.environ["RANK"])
  local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
  if device is not None and torch.device(device).type == "cpu":
    dev, backend = resolve_device("cpu"), "gloo"
  else:
    resolve_device(None)            # raises without CUDA; TF32 off
    cards = torch.cuda.device_count()
    if device is not None and torch.device(device).index is not None:
      dev = torch.device(device)
    else:
      local_rank = int(os.environ.get("LOCAL_RANK", rank))
      dev = torch.device("cuda", local_rank % cards)
    torch.cuda.set_device(dev)
    backend = "nccl" if local_world <= cards else "gloo"
  if not dist.is_initialized():
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            rank=rank, world_size=world)
    atexit.register(_shutdown)
  backend = dist.get_backend()
  header = dist.new_group(backend="gloo", timeout=HEADER_TIMEOUT)
  if rank == 0:
    print(f"mesh: {world} rank(s) over {backend}", flush=True)
  return Mesh(rank=rank, world=world, device=dev, backend=backend,
              header_group=header)


def _shutdown() -> None:
  global _MESH
  _MESH = None
  if dist.is_initialized():
    dist.destroy_process_group()


def shard_ray_batch(mesh: Mesh, rb: Dict[str, Any]) -> Dict[str, Any]:
  """This rank's rows of a global ray batch: axis 0 of the per-ray keys,
  axis 1 of ``flows`` / ``flow_masks``; everything else whole."""
  rows = mesh.rows(rb["ray_o"].shape[0])
  out = {}
  for k, v in rb.items():
    if k in RAY_SHARDED_KEYS:
      out[k] = v[rows]
    elif k in RAY_SHARDED_AXIS1_KEYS:
      out[k] = v[:, rows]
    else:
      out[k] = v
  return out


def agree(mesh: Mesh, value: int, what: str) -> None:
  """Raise on every rank unless every rank holds the same ``value``."""
  both = torch.tensor([value, -value], dtype=torch.float64,
                      device=mesh.device)
  hi, neg_lo = mesh.all_reduce_max(both).tolist()
  if hi != -neg_lo:
    raise RuntimeError(f"the ranks disagree on {what} ({-neg_lo:g} to "
                       f"{hi:g}): every rank must read rank 0's files (one "
                       "host, or a shared filesystem)")


@torch.no_grad()
def replicate(mesh: Mesh, model: torch.nn.Module,
              opt: Optional[torch.optim.Optimizer] = None) -> None:
  """Broadcast rank 0's parameters, buffers and optimizer state (after a
  load) to every rank, in place."""
  tensors = list(model.parameters()) + list(model.buffers())
  if opt is not None:
    for group in opt.param_groups:
      for p in group["params"]:
        state = opt.state.get(p, {})
        tensors += [state[k] for k in sorted(state)
                    if torch.is_tensor(state[k])]
  for t in tensors:
    # optimizer step counts live on the host: NCCL sends them via the card
    buf = t.detach().to(mesh.device)
    mesh.broadcast(buf)
    if buf.data_ptr() != t.data_ptr():
      t.detach().copy_(buf)


def sum_gradients(mesh: Mesh, params: Sequence[torch.nn.Parameter],
                  scalars: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
  """One all-reduce (SUM) of a flat buffer of the gradients and the step's
  scalars; each parameter's ``grad`` becomes the sum over the ranks, and
  the summed scalars are returned.  Every rank runs one graph (no branch
  of a step depends on the data), so the same parameters have gradients
  on every rank, and nothing here waits for the device."""
  names = list(scalars)
  owners = [p for p in params if p.grad is not None]
  flat = mesh.all_reduce(torch.cat(
      [p.grad.reshape(-1) for p in owners]
      + [torch.stack([scalars[k].detach().float().reshape(())
                      for k in names])]))
  off = 0
  for p in owners:
    p.grad = flat[off:off + p.numel()].view_as(p)
    off += p.numel()
  return {k: flat[off + i] for i, k in enumerate(names)}
