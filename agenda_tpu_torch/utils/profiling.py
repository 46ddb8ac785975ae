"""Step timing and optional device profiling of a training loop.

Counterpart of ``agenda_tpu/utils/profiling.py``: ``StepTimer`` as there,
and ``maybe_profile`` on ``torch.profiler`` (CPU and, when present, CUDA
activity), writing a Chrome trace into the directory given.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Trace the enclosed loop with torch.profiler when ``trace_dir`` is set."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class StepTimer:
    """Rolling steps/sec over a window of (step, time) ticks. The rate comes
    from the step counter's delta, so ticking only at log steps still gives
    steps per second."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []  # (step, time) pairs

    def tick(self, step: int | None = None) -> float:
        now = time.time()
        prev_step = self.times[-1][0] if self.times else -1
        self.times.append((step if step is not None else prev_step + 1, now))
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 2:
            return 0.0
        (s0, t0), (s1, t1) = self.times[0], self.times[-1]
        if t1 <= t0:
            return 0.0
        return (s1 - s0) / (t1 - t0)
