"""Reading the traced window: device intervals and the host's spans.

``read_profile`` takes the events of a finished ``torch.profiler`` run:
every activity on the card (kernels, copies, sets) and the benchmark's
own spans (``bench/<name>`` annotations, recorded by ``Context.span``).
``summarize`` reduces them to the device's busy seconds (the union of the
device intervals), the traced window (the first to the last event of the
active steps), each kernel's device seconds by name, and the longest
idle gaps of the card, each named by the innermost benchmark span that
was open on the host at the gap's middle.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Tuple

Event = Tuple[str, str, int, int]       # (kind, name, start_ns, end_ns)


def _ns(ev, attr: str) -> int:
  for name, scale in ((f"{attr}_ns", 1), (f"{attr}_us", 1000)):
    fn = getattr(ev, name, None)
    if fn is not None:
      return int(fn() * scale)
  raise AttributeError(attr)


def _annotation(name: str) -> bool:
  """A host range mirrored on the device timeline (the profiler's step
  markers and the benchmark's spans): no device work of its own."""
  return name.startswith(("bench/", "ProfilerStep"))


def read_profile(prof) -> List[Event]:
  """(kind, name, start, end) of each device activity ("device") and each
  benchmark span ("span"), in ns on the profiler's clock."""
  out: List[Event] = []
  for ev in prof.profiler.kineto_results.events():
    name = ev.name()
    start = _ns(ev, "start")
    end = start + _ns(ev, "duration")
    if str(ev.device_type()).endswith("CUDA"):
      if not _annotation(name):
        out.append(("device", name, start, end))
    elif name.startswith("bench/"):
      out.append(("span", name[6:], start, end))
    else:
      out.append(("host", name, start, end))
  return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
  merged: List[Tuple[int, int]] = []
  for s, e in sorted(intervals):
    if merged and s <= merged[-1][1]:
      if e > merged[-1][1]:
        merged[-1] = (merged[-1][0], e)
    else:
      merged.append((s, e))
  return merged


def summarize(events: List[Event]) -> Dict[str, Any]:
  dev = [(s, e) for k, _, s, e in events if k == "device" and e > s]
  spans = [(n, s, e) for k, n, s, e in events if k == "span"]
  if not events:
    return {"busy_s": 0.0, "window_s": 0.0, "kernels_s": {},
            "breakdown": {"device_ops": [], "idle_gaps": []}}
  t0 = min(s for _, _, s, _ in events)
  t1 = max(e for _, _, _, e in events)
  busy = _union(dev)
  busy_ns = sum(e - s for s, e in busy)
  by_name: Dict[str, float] = collections.defaultdict(float)
  for k, n, s, e in events:
    if k == "device":
      by_name[n] += (e - s) * 1e-9
  gaps = []
  prev = t0
  for s, e in busy + [(t1, t1)]:
    if s > prev:
      gaps.append((prev, s))
    prev = max(prev, e)
  named: Dict[str, float] = collections.defaultdict(float)
  for s, e in gaps:
    mid = (s + e) // 2
    open_spans = [(se - ss, n) for n, ss, se in spans if ss <= mid <= se]
    label = min(open_spans)[1] if open_spans else "outside spans"
    named[label] += (e - s) * 1e-9
  ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
  idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
  return {"busy_s": busy_ns * 1e-9, "window_s": (t1 - t0) * 1e-9,
          "kernels_s": dict(by_name),
          "breakdown": {"device_ops": [[n, v] for n, v in ops],
                        "idle_gaps": [[n, v] for n, v in idle]}}
