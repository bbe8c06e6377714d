"""Training-dataset factory: weighted mixtures of scenes/datasets.

Port of ``dynibar_tpu.data.factory``.  The port trains on one card (a
larger mesh is ROADMAP queue 1 item 11), so the process index and count
are the caller's (default 0 of 1) instead of JAX's.

Rebuild of reference ibrnet/data_loaders/create_training_dataset.py:41-127:
``train_dataset`` may be a single dataset or a '+'-concatenated list with
per-dataset sampling weights; in distributed mode processes must contribute
disjoint rays.  Here a dataset is a `sample_batch(rng, ...)` provider; the
mixture picks a provider per step by weight.

Multi-host disjointness (replacing DistributedSampler/
DistributedSamplerWrapper): the *view-level* stream (target frame, source
selection, anchors) is process-SHARED — every rank must build bit-identical
replicated batch keys, because `jax.make_array_from_process_local_data`
requires replica hosts to pass identical data — while the *pixel* stream is
per-process (`fold_pixel_rng`), so the globally-sharded ray axis carries
process_count × N_rand distinct rays of the same target view.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from dynibar_tpu_torch.config import DynibarConfig

# registry: name -> callable(config, scene) -> provider with
# sample_batch(rng, n_rays, sample_mode) and set_epoch(epoch)
DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
  def deco(fn):
    DATASET_REGISTRY[name] = fn
    return fn
  return deco


@register_dataset("monocular")
def _make_monocular(config: DynibarConfig, scene: str):
  from dynibar_tpu_torch.data.monocular import MonocularSceneData
  return MonocularSceneData(config, scene)


def fold_pixel_rng(rng: np.random.RandomState,
                   process_index: int) -> np.random.RandomState:
  """Derive the per-process pixel stream from the shared view stream.

  Consumes ONE draw from `rng` (the same draw on every rank, keeping the
  shared streams aligned) and folds the process index in, so ranks sample
  disjoint ray positions of the identical view-level batch."""
  return np.random.RandomState(
      (rng.randint(0, 2 ** 31 - 1) * 2654435761 + process_index)
      % (2 ** 31 - 1))


class MixtureDataset:
  """Weighted mixture over providers; shared view stream, per-rank pixels."""

  def __init__(self, providers: Sequence, weights: Sequence[float],
               process_index: int = 0, process_count: int = 1):
    assert len(providers) == len(weights) and providers
    self.providers = list(providers)
    w = np.asarray(weights, np.float64)
    self.weights = w / w.sum()
    self.process_index = process_index
    self.process_count = process_count
    self.num_frames = max(p.num_frames for p in self.providers)

  def set_epoch(self, epoch: int):
    for p in self.providers:
      p.set_epoch(epoch)

  def sample_batch(self, rng: np.random.RandomState, n_rays: int,
                   sample_mode: str = "uniform"):
    # multi-host: rng stays the process-shared view stream; only the ray
    # positions come from a per-process stream (see module docstring)
    pixel_rng = (fold_pixel_rng(rng, self.process_index)
                 if self.process_count > 1 else None)
    idx = rng.choice(len(self.providers), p=self.weights)
    return self.providers[idx].sample_batch(rng, n_rays, sample_mode,
                                            pixel_rng=pixel_rng)


def create_training_dataset(config: DynibarConfig, process_index: int = 0,
                            process_count: int = 1) -> MixtureDataset:
  """'name1+name2' datasets with equal weights unless one dataset."""
  names = config.train_dataset.split("+")
  scenes = config.train_scenes or [""]
  providers = []
  for name in names:
    maker = DATASET_REGISTRY.get(name)
    if maker is None:
      raise SystemExit(
          f"error: unknown train_dataset '{name}'; "
          f"registered: {sorted(DATASET_REGISTRY)}")
    for scene in scenes:
      providers.append(maker(config, scene))
  weights = [1.0 / len(providers)] * len(providers)
  return MixtureDataset(providers, weights, process_index, process_count)
