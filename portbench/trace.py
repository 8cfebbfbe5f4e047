"""The device trace of a ``--trace 1`` run, from ``torch.profiler``, reduced
to what the per-layer readers and the ``breakdown`` need.

The traced window is the benchmark's own ``portbench.window`` range.  Busy
time is the union of the device's activity intervals inside it (kernels,
copies and sets, overlapping or not), so nothing is counted twice.  Idle
gaps are the rest of the window, each named by what the host was doing at
its middle: the innermost operator then running on the benchmark's thread
(runtime calls skipped), under the innermost of the query driver's
``portbench.*`` ranges that held it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW = "portbench.window"


class Trace:
    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> "TraceData":
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == cuda:
                # the GPU-side copies of the benchmark's own ranges are no work
                if not e.name().startswith("portbench."):
                    dev.append(item)
            else:
                host.append(item + (e.start_thread_id(),))
        self._prof = None
        return TraceData(dev, host)


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cu") and name[2:3].isupper()


class TraceData:
    """Device intervals ``(name, start_ns, end_ns)`` and host intervals
    ``(name, start_ns, end_ns, thread)`` of one traced window."""

    def __init__(self, device_events, host_events):
        windows = [e for e in host_events if e[0] == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no portbench.window range")
        _, self.start, self.end, self.thread = windows[0]
        self.device = sorted((e for e in device_events
                              if e[2] > self.start and e[1] < self.end),
                             key=lambda e: e[1])
        self.host = sorted((e for e in host_events if e[3] == self.thread
                            and e[2] > self.start and e[1] < self.end),
                           key=lambda e: (e[1], -e[2]))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def ranges(self, name: str) -> list:
        """The host intervals of the benchmark's range ``name``."""
        return [(e[1], e[2]) for e in self.host if e[0] == name]

    def busy_intervals(self) -> list:
        merged = []
        for _, a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_seconds(self, parts, outside=()) -> float:
        """Device time of the activities whose names hold one of ``parts``
        and that start outside every host interval of ``outside``."""
        starts = sorted(outside)
        total = 0
        for name, a, b in self.device:
            if not any(p in name for p in parts):
                continue
            i = bisect.bisect_right(starts, (a, float("inf"))) - 1
            if i >= 0 and starts[i][0] <= a <= starts[i][1]:
                continue
            total += b - a
        return total / 1e9

    def top_device_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for name, a, b in self.device:
            by[name] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time of the window summed by what the host was doing, the
        ``k`` largest."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        by = defaultdict(int)
        stack, i = [], 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while i < len(self.host) and self.host[i][1] <= mid:
                stack.append(self.host[i])
                i += 1
            stack = [e for e in stack if e[2] >= mid]
            mark = next((e[0] for e in reversed(stack) if e[0] != WINDOW
                         and e[0].startswith("portbench.")), "portbench")
            op = next((e[0] for e in reversed(stack) if not _is_runtime(e[0])
                       and not e[0].startswith("portbench")), "python")
            by[f"{mark}: {op}"] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], ns / 1e9] for name, ns in top]
