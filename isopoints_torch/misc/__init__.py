"""Host-side helpers (port of isopoints_tpu/misc/__init__.py): a thread
that runs a task, such as writing a plot or an artifact, beside the
training loop and logs its wall time; a task that fails is logged and
never stops training."""

import threading
import time
from typing import Callable, Optional

from isopoints_torch.logger import get_logger


class TimedThread(threading.Thread):
    """Run fn(*args, **kwargs) on a daemon thread; log the wall time when
    it finishes, or the exception it raised (misc/__init__.py:15-35)."""

    def __init__(self, fn: Callable, *args, name: Optional[str] = None,
                 **kwargs):
        super().__init__(daemon=True)
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self._label = name or getattr(fn, "__name__", "task")

    def run(self):
        t0 = time.time()
        try:
            self._fn(*self._args, **self._kwargs)
        except Exception as e:  # a side task must never stop training
            get_logger().warning("async %s failed: %s", self._label, e)
            return
        get_logger().debug("async %s done in %.1fs", self._label,
                           time.time() - t0)


def run_async(fn: Callable, *args, **kwargs) -> TimedThread:
    """Start fn(*args, **kwargs) on a `TimedThread` and return it."""
    t = TimedThread(fn, *args, **kwargs)
    t.start()
    return t
