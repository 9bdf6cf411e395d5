"""The program's spans and counters, kept in memory.

Tracing is on exactly while a `torch.profiler` session records
(`torch._C._autograd._profiler_enabled()`): the benchmark's traced window,
`train_mvr --profile-at`. There is no flag. A call that finds the profiler
on after one that found it off clears the log, so the log holds the newest
session. Off, `span` returns one shared null context and the counters
return at once.

- `span(name, request=False)`: records name, start and end (Unix-epoch ns
  from `time.time_ns()`, the clock of the profiler's events), the
  enclosing span and a request id, and enters
  `torch.profiler.record_function(name)`, so the span is in the profiler's
  trace too. `request=True` opens a new request id, which the spans inside
  it share; a span outside any request has none.
- `count(name, k)`: adds the host integer `k` to a counter.
- `count_device(name, t, k)`: adds k x the sum of the device tensor `t` (a
  mask counts its true entries) to a counter: one reduction a call and no
  synchronisation; `snapshot()` reads the sums.
- `launch(kernel, n, **mode)`: a kernel launch's record (what
  `ops/_build.LaunchCount.launch` appends).
- `snapshot()` returns {"spans", "counters", "launches"}; `reset()` clears.
- `union(intervals)`: merged intervals, overlaps counted once.
"""

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

import torch

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_FOLD = 64          # device partial sums kept before they are added up


class _Log:
    def __init__(self):
        self.spans: List[dict] = []
        self.stack: List[int] = []
        self.requests = 0
        self.counters: Dict[str, int] = {}
        self.pending: Dict[Tuple[str, int], List[torch.Tensor]] = {}
        self.device: Dict[Tuple[str, int], torch.Tensor] = {}
        self.launches: List[dict] = []


_log = _Log()
_was_on = False


def reset() -> None:
    """Clear the log."""
    global _log
    _log = _Log()


def on() -> bool:
    """Whether a profiler session records now; the first call that finds
    one after finding none clears the log."""
    global _was_on
    if not _profiling():
        _was_on = False
        return False
    if not _was_on:
        _was_on = True
        reset()
    return True


class _Span:
    __slots__ = ("name", "request", "log", "rec", "rf")

    def __init__(self, name: str, request: bool):
        self.name = name
        self.request = request

    def __enter__(self):
        log = self.log = _log
        parent = log.stack[-1] if log.stack else None
        if self.request:
            log.requests += 1
            rid = log.requests
        else:
            rid = log.spans[parent]["request"] if parent is not None else None
        self.rec = {"name": self.name, "start_ns": 0, "end_ns": 0,
                    "parent": parent, "request": rid}
        log.stack.append(len(log.spans))
        log.spans.append(self.rec)
        self.rf = torch.profiler.record_function(self.name)
        self.rec["start_ns"] = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec["end_ns"] = time.time_ns()
        self.log.stack.pop()
        return False


def span(name: str, request: bool = False):
    """A context manager: the span `name` while tracing is on, else the
    shared null context."""
    if not on():
        return _NULL
    return _Span(name, request)


def count(name: str, k: int = 1) -> None:
    """Add the host integer `k` to counter `name`."""
    if on():
        c = _log.counters
        c[name] = c.get(name, 0) + k


def count_device(name: str, t: torch.Tensor, k: int = 1) -> None:
    """Add k x sum(t) to counter `name`, on t's device, without a sync."""
    if on():
        p = _log.pending.setdefault((name, k), [])
        p.append(torch.sum(t, dtype=torch.int64))
        if len(p) >= _FOLD:
            _fold(_log, (name, k))


def _fold(log: _Log, key: Tuple[str, int]) -> None:
    p = log.pending.pop(key, [])
    if p:
        s = torch.stack(p).sum()
        acc = log.device.get(key)
        log.device[key] = s if acc is None else acc + s


def launch(kernel: str, n: int, **mode) -> None:
    """Record a kernel launch of size `n` in its `mode`."""
    if on():
        _log.launches.append({"kernel": kernel, "n": n, **mode})


def snapshot() -> dict:
    """The log: spans (name, start_ns, end_ns, parent index, request id),
    counters (host and device, the device sums read here), launches."""
    on()
    log = _log
    for key in list(log.pending):
        _fold(log, key)
    counters = dict(log.counters)
    for (name, k), acc in log.device.items():
        counters[name] = counters.get(name, 0) + k * int(acc)
    return {"spans": [dict(s) for s in log.spans], "counters": counters,
            "launches": [dict(r) for r in log.launches]}


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals: each instant covered counts once."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]

