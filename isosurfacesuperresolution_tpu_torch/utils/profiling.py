"""Frame timing and tracing.

Counterpart of the JAX package's `utils/profiling.py`:

* :class:`FrameTimer` - rolling per-frame wall clock; `stop` reads one
  value of the frame's result to the host, which waits for the device.
* :func:`trace` - a `torch.profiler` scope (the host, and the card when
  there is one) that writes a Chrome trace into ``log_dir``.
* :func:`timed_chain` - seconds an iteration of a carried ``step``: ``n``
  iterations as a warm-up, then ``n`` timed ones, each fed the previous
  one's carry, with the carry's device synchronised before each clock
  read.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Any, Callable, Optional

import torch


def first_tensor(tree: Any) -> Optional[torch.Tensor]:
    """The first tensor leaf of a nest of tuples, lists and dicts (dict
    keys in sorted order, as JAX orders a pytree's leaves)."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        for v in tree:
            t = first_tensor(v)
            if t is not None:
                return t
    return None


def _sync(t: Optional[torch.Tensor]) -> None:
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class FrameTimer:
    """Rolling FPS / ms statistics over the last ``window`` frames."""

    def __init__(self, window: int = 10):
        self.times = deque(maxlen=window)
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, result=None) -> float:
        """Stop timing; reads one value of ``result``'s first tensor to
        the host, so the device has finished it.  Returns the frame time
        in seconds."""
        t = first_tensor(result)
        if t is not None:
            float(t.reshape(-1)[0])
        dt = time.time() - self._t0
        self.times.append(dt)
        return dt

    @property
    def fps(self) -> float:
        return len(self.times) / sum(self.times) if self.times else 0.0

    @property
    def ms(self) -> float:
        return (1000.0 * sum(self.times) / len(self.times) if self.times
                else 0.0)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("build", "torch-trace")):
    """Profile the scope with `torch.profiler` (CPU, and CUDA when a card
    is there) and write ``log_dir/trace.json``, a Chrome trace (open it
    in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_chain(step: Callable, carry0, n: int = 10,
                fetch: Callable = lambda c: torch.sum(first_tensor(c))
                ) -> float:
    """Per-iteration wall time of ``step`` (carry -> carry), in seconds.

    Runs ``n`` chained iterations as a warm-up, then times ``n`` more;
    each iteration takes the previous carry, and ``fetch`` of the last
    carry is read to the host after synchronising its device."""
    def chain(c):
        for _ in range(n):
            c = step(c)
        out = fetch(c)
        _sync(out)
        return float(out)

    chain(carry0)
    t0 = time.time()
    chain(carry0)
    return (time.time() - t0) / n
