"""Multi-scene session registry: one server process, many resident scenes.

Port of ``dynibar_tpu.serve.registry``.  The reference renders one scene
per process (render_monocular_bt.py is a one-shot batch script); a
deployment serves a catalog.  The registry lazily constructs one
:class:`RenderSession` per scene named in ``config.train_scenes`` and
keeps at most ``max_sessions`` resident (LRU-evicted: each session pins
its weights and feature maps on the card).

Per-scene checkpoints follow the config's own layout: each session gets
``dataclasses.replace(config, train_scenes=[scene])``, so ``out_folder()``
resolves per scene exactly as training wrote it.  An injected
``state_dict`` (tests, shared-weights deployments) is reused across
scenes.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Dict, List, Optional

import torch

from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.serve.session import RenderSession
from dynibar_tpu_torch.utils.device import DeviceLike


class SessionRegistry:
  """Lazily-built, LRU-bounded map scene name -> RenderSession."""

  def __init__(self, config: DynibarConfig,
               state_dict: Optional[Dict[str, torch.Tensor]] = None,
               featmap_cache: int = 8, max_sessions: int = 4,
               device: DeviceLike = None):
    if not config.train_scenes:
      raise ValueError("config.train_scenes is empty")
    self.config = config
    self.available: List[str] = list(config.train_scenes)
    self._state_dict = state_dict
    self._featmap_cache = featmap_cache
    self._max_sessions = max_sessions
    self._device = device
    self._sessions: "collections.OrderedDict[str, RenderSession]" = (
        collections.OrderedDict())
    self._lock = threading.Lock()
    self.default_scene = self.available[0]

  @classmethod
  def from_session(cls, session: RenderSession) -> "SessionRegistry":
    """Wrap an existing single session (for callers that built a
    RenderSession themselves, e.g. with injected weights)."""
    reg = cls(session.config, state_dict=session.model.state_dict(),
              featmap_cache=session._cache_size, max_sessions=1,
              device=session.device)
    reg._sessions[reg.default_scene] = session
    return reg

  # ------------------------------------------------------------------ access
  def get(self, scene: Optional[str] = None) -> RenderSession:
    """The session for `scene` (default: first configured), building it on
    first use and evicting the least-recently-used session over capacity."""
    name = scene or self.default_scene
    if name not in self.available:
      raise KeyError(f"unknown scene {name!r}; available: {self.available}")
    with self._lock:
      if name in self._sessions:
        self._sessions.move_to_end(name)
        return self._sessions[name]
      cfg = dataclasses.replace(self.config, train_scenes=[name])
      session = RenderSession(cfg, state_dict=self._state_dict,
                              featmap_cache=self._featmap_cache,
                              device=self._device)
      self._sessions[name] = session
      while len(self._sessions) > self._max_sessions:
        self._sessions.popitem(last=False)
      return session

  # ------------------------------------------------------------------- meta
  def scenes(self) -> Dict[str, Any]:
    with self._lock:
      loaded = list(self._sessions)
    return {"available": self.available, "loaded": loaded,
            "default": self.default_scene,
            "max_sessions": self._max_sessions}
