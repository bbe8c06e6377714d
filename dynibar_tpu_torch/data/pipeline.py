"""Host-side input pipeline: threaded prefetch of ray batches.

Port of ``dynibar_tpu.data.pipeline.PrefetchPipeline``.  Worker threads
call ``sample_fn(rng)`` with the same per-worker ``RandomState`` streams
as the JAX pipeline, (seed, worker id, step) -> one seed, so both yield the
same batches (in the same order with one worker).  Threads suffice: the
decode path (zlib, numpy) releases the interpreter lock.  Given a
device, the workers also turn each numpy batch into tensors as
``utils/device.to_device`` does (floating -> f32, integer -> int64) and,
for a CUDA device, pin them; the consumer only issues the copies, with
``non_blocking=True``, so they overlap the step already queued on the
card.  ``wait_s`` sums the host time the consumer spent in ``__next__``
(blocked on the queue, then issuing the copies): the share of a step the
data path did not hide from the thread that launches the step.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator

import numpy as np
import torch


def _to_host_tensor(v, pin: bool) -> torch.Tensor:
  t = torch.from_numpy(np.ascontiguousarray(v))
  t = t.float() if t.is_floating_point() else t.long()
  return t.pin_memory() if pin else t


class PrefetchPipeline:
  """Prefetches ``sample_fn(rng)`` results with N worker threads."""

  def __init__(self, sample_fn: Callable[[np.random.RandomState],
                                         Dict[str, np.ndarray]],
               num_workers: int = 2, prefetch_depth: int = 4,
               seed: int = 0, device: torch.device = None):
    self._sample_fn = sample_fn
    self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
    self._stop = threading.Event()
    self._seed = seed
    self._device = device
    self.wait_s = 0.0
    self._threads = [
        threading.Thread(target=self._worker, args=(wid,), daemon=True)
        for wid in range(max(1, num_workers))]
    for t in self._threads:
      t.start()

  def _worker(self, wid: int):
    step = 0
    while not self._stop.is_set():
      rng = np.random.RandomState(
          (self._seed * 1_000_003 + wid * 7919 + step) % (2 ** 31 - 1))
      try:
        batch = self._sample_fn(rng)
        if self._device is not None:
          pin = self._device.type == "cuda"
          batch = {k: _to_host_tensor(v, pin) for k, v in batch.items()}
      except Exception as exc:  # surfaced to the consumer by __next__
        self._queue.put(exc)
        return
      while not self._stop.is_set():
        try:
          self._queue.put(batch, timeout=0.5)
          break
        except queue.Full:
          continue
      step += 1

  def __iter__(self) -> Iterator[Dict]:
    return self

  def __next__(self) -> Dict:
    t0 = time.perf_counter()
    item = self._queue.get()
    if isinstance(item, Exception):
      raise item
    if self._device is not None:
      item = {k: v.to(self._device, non_blocking=True)
              for k, v in item.items()}
    self.wait_s += time.perf_counter() - t0
    return item

  def close(self):
    self._stop.set()
    for t in self._threads:
      t.join(timeout=2.0)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False
