"""The port's own spans and counters, at the boundaries of its layers.

A span is a torch.profiler range named `ldpc.<name>`, so it lies on the
same clock as the device's kernels in any profiler window: the CLI's
--profile-dir Chrome trace, a traced benchmark run, an operator's own
profiler. Spans are on exactly while such a window records; the check is
one call (torch.autograd._profiler_enabled, ~0.1-0.2 us). Off, a span
enters no record_function, reads no clock, records no CUDA event and
changes no counter. On, it also adds 1 to `span.<attr>_n` and its host
nanoseconds to `span.<attr>_ns` (<attr>: the name with "." as "_"),
integers kept on the function `span` as the port keeps its launch counts
on its launch functions, so a reader takes them as deltas over a window.

The spans, a fixed set (span() raises KeyError on any other name):

  decode.prepare  decode/layered_qc._launch_minsum (K1a) and _launch_exact
                  (K1c), from entry to just before the library call: input
                  checks, argument tensors, device tables, the launch plan
                  (tile plan, resident clusters, allocations), the library
  decode.launch   the same, around the library call (the launch itself)
  retry.ok_read   decode/api.with_retry: the host blocked on the primary's
                  ok flags (their device-to-host copy)
  retry.dispatch  with_retry, on batches with failed frames only: from the
                  flags on the host to the fallback's launch returning (the
                  failed rows' index, its host-to-device copy, the gather,
                  the fallback's prepare and launch); the card has nothing
                  queued then
  encode          sim/runner.Pipeline.llr, around the encoder's call
  channel         Pipeline.llr, around the channel's call
  tally           Pipeline.counts, around tally_counts

Device time of a launch (launch()): while spans are on, a CUDA event pair
on the launch's stream around the library call. Pairs are resolved without
a synchronisation: each later span entry takes the pairs whose end event
has completed and adds their time to `<launch function>.device_us` (whole
microseconds) and 1 to `.device_timed`, so device_us / device_timed is an
exact mean over the resolved launches even where the window's last pairs
are still pending (those count at the next window's first span). Where
the stream was idle when the start event was recorded, a pair also holds
the library call's own host time before the kernel starts (~0.1 ms with a
profiler recording, against a decode's milliseconds).
"""
from __future__ import annotations

import contextlib
import time

import torch

SPANS = ("decode.prepare", "decode.launch", "retry.ok_read",
         "retry.dispatch", "encode", "channel", "tally")
# span -> (its entry counter, its nanosecond counter) on the function span
_ATTRS = {s: (s.replace(".", "_") + "_n", s.replace(".", "_") + "_ns")
          for s in SPANS}
_OFF = contextlib.nullcontext()
_PENDING = []  # [(launch function, start event, end event)] not yet done

recording = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("attrs", "range", "t0")

    def __init__(self, name: str, attrs: tuple):
        self.attrs = attrs
        self.range = torch.profiler.record_function(f"ldpc.{name}")

    def __enter__(self):
        if _PENDING:
            _resolve()
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        n, ns = self.attrs
        counts = span.__dict__
        counts[n] += 1
        counts[ns] += dt
        return False


def span(name: str):
    """The span `name` (SPANS) as a context manager: a no-op unless a
    profiler window records."""
    attrs = _ATTRS[name]
    if not recording():
        return _OFF
    return _Span(name, attrs)


for _n, _ns in _ATTRS.values():
    setattr(span, _n, 0)
    setattr(span, _ns, 0)


class _Launch:
    __slots__ = ("fn", "stream", "span", "start")

    def __init__(self, fn, device):
        self.fn = fn
        self.stream = torch.cuda.current_stream(device)
        self.span = span("decode.launch")

    def __enter__(self):
        self.span.__enter__()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _PENDING.append((self.fn, self.start, end))
        return self.span.__exit__(*exc)


def launch(fn, device: torch.device):
    """The decode.launch span around one launch of the kernel whose wrapper
    is `fn` (layered_decode_cuda, layered_exact_cuda) on `device`'s
    current stream, its device time kept on fn.device_us and
    fn.device_timed once resolved; a no-op unless a profiler window
    records."""
    if not recording():
        return _OFF
    return _Launch(fn, device)


def _resolve() -> None:
    """Add the pending pairs whose end event has completed to their
    launch function's device_us and device_timed (no synchronisation)."""
    left = []
    for fn, start, end in _PENDING:
        if end.query():
            fn.device_us += round(start.elapsed_time(end) * 1e3)
            fn.device_timed += 1
        else:
            left.append((fn, start, end))
    _PENDING[:] = left
