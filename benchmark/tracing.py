"""The traced run's instruments: the benchmark's own spans around the calls
into each layer of the port, and torch.profiler over the measured window.

Spans are host ranges named `bench.<layer>` (torch.profiler's
record_function; free when tracing is off) and, where a layer's device time
is wanted, CUDA events recorded on the stream before and after the call.
From the profiler the summary takes every device activity (kernels, copies,
fills): their union is the device's busy time; the holes in it inside the
window are idle gaps, each named by the innermost benchmark span the host
was in at its middle; device time is summed by kernel name.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

TOP = 10
NAME_CHARS = 120


def stamp(device: torch.device):
    """A point in time on the device's stream: a recorded CUDA event, or
    the host clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def wait(mark) -> None:
    """Block until the device reaches `mark`."""
    if not isinstance(mark, float):
        mark.synchronize()


def elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


class Tracer:
    """Spans and the profiler of one run; everything is a no-op unless
    `enabled`."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self.events = collections.defaultdict(list)  # span -> [(start, end)]

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    @contextlib.contextmanager
    def timed(self, name: str):
        """A span whose device time is kept too (CUDA events)."""
        if not self.enabled:
            yield
            return
        with self.span(name):
            start = stamp(self.device)
            yield
            end = stamp(self.device)
        self.events[name].append((start, end))

    def span_ms(self) -> dict:
        """{span: [device ms of each]} of the timed spans (after a sync)."""
        return {k: [elapsed_ms(s, e) for s, e in v]
                for k, v in self.events.items()}

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        self.prof = prof

    def summary(self, request: str) -> dict | None:
        """busy_s, window_s (the span of the benchmark's ranges in the
        trace), kernels {name: [count, seconds]}, device_ops and idle_gaps
        (the TOP largest, [[name, seconds]]), and requests_traced: how many
        spans named `request` saw a device activity start inside them."""
        if self.prof is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        device, spans = [], []
        # the profiler's raw records: building its FunctionEvent tree takes
        # minutes for a window of some 10^5 launches
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.is_user_annotation():
                if e.device_type() != cuda and name.startswith("bench."):
                    spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3,
                                  name[len("bench."):]))
            elif e.device_type() == cuda:
                device.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name))
        if not spans:
            return None
        lo = min(s for s, _, _ in spans)
        hi = max(e for _, e, _ in spans)
        kernels = collections.defaultdict(lambda: [0, 0.0])
        for s, e, name in device:
            kernels[name][0] += 1
            kernels[name][1] += (e - s) / 1e6
        merged = []
        for s, e, _ in sorted(device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        edges = [lo] + [x for m in merged for x in m] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans.sort()
        starts = [s for s, _, _ in spans]

        def host_span(t):
            # the shortest of the last benchmark spans begun by time t that
            # holds it
            i = bisect.bisect_right(starts, t)
            best = None
            for s, e, name in spans[max(0, i - 64):i]:
                if s <= t <= e and (best is None or e - s < best[0]):
                    best = (e - s, name)
            return best[1] if best else "harness"

        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        named = [(e - s, host_span((s + e) / 2)) for s, e in longest]
        ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        begins = sorted(s for s, _, _ in device)
        traced = sum(1 for s, e, name in spans if name == request
                     and bisect.bisect_right(begins, e)
                     > bisect.bisect_left(begins, s))
        return {
            "requests_traced": traced,
            "busy_s": busy / 1e6,
            "window_s": (hi - lo) / 1e6,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "device_ops": [[k[:NAME_CHARS], v[1]] for k, v in ops],
            "idle_gaps": [[name, us / 1e6] for us, name in named],
        }
