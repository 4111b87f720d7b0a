"""The port's spans and counters (ecc_ldpc_tpu_torch/trace.py): off without
a profiler, on inside one, read by the benchmark's counters and by the four
per-layer metrics that read them; on the card, each K1a/K1c launch's device
time from CUDA events, resolved without a synchronisation."""
import contextlib
import importlib
import inspect
import pkgutil
import statistics
import sys

import pytest
import torch

import ecc_ldpc_tpu_torch
from benchmark import harness
from benchmark.tracing import Tracer
from ecc_ldpc_tpu_torch import trace
from ecc_ldpc_tpu_torch.decode.api import with_retry
from ecc_ldpc_tpu_torch.decode.layered_qc import (
    layered_decode_cuda,
    layered_exact_cuda,
)
from ecc_ldpc_tpu_torch.decode.types import DecodeResult
from ecc_ldpc_tpu_torch.sim.runner import Pipeline, SweepSpec

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _span_counts() -> dict:
    return {k: v for k, v in vars(trace.span).items() if isinstance(v, int)}


def _pipeline(batch=4):
    return Pipeline.build(SweepSpec(code="mackay1008",
                                    decoder="minsum/norm:0.8125/2",
                                    ebn0_db=(2.0,), batch=batch), CPU)


def _ranges(prof) -> list:
    """[(name, start ns, end ns)] of the user ranges the profiler kept."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _inside(ranges, outer: str) -> dict:
    """{ldpc range: how many lie inside a range named `outer`}."""
    outs = [(s, e) for n, s, e in ranges if n == outer]
    got = {}
    for n, s, e in ranges:
        if n.startswith("ldpc."):
            got[n] = got.get(n, 0) + any(a <= s and e <= b for a, b in outs)
    return got


def test_the_span_table_is_fixed():
    assert set(trace.SPANS) == {"decode.prepare", "decode.launch",
                                "retry.ok_read", "retry.dispatch", "encode",
                                "channel", "tally"}
    for name in trace.SPANS:
        assert name in trace.__doc__
    with pytest.raises(KeyError):
        trace.span("decode.prep")
    assert set(_span_counts()) == {f"{s.replace('.', '_')}_{x}"
                                   for s in trace.SPANS for x in ("n", "ns")}


def test_off_enters_no_range_reads_no_clock_records_no_event(monkeypatch):
    """Without a profiler a span is the shared no-op: no record_function,
    no clock, no CUDA event, no counter moved, on the whole sweep step and
    retry path."""
    assert not trace.recording()

    def refuse(*a, **k):
        raise AssertionError("called with the spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trace.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    before = _span_counts()
    timed = (layered_decode_cuda.device_timed, layered_exact_cuda.device_timed)
    for name in trace.SPANS:
        assert trace.span(name) is trace._OFF
    assert trace.launch(layered_decode_cuda, CPU) is trace._OFF
    pipe = _pipeline()
    gen = torch.Generator()
    gen.manual_seed(1)
    pipe.counts(*pipe.draw(gen), 2.0)
    with_retry(*_stubs((1,)))(_llr(B))
    assert _span_counts() == before
    assert (layered_decode_cuda.device_timed,
            layered_exact_cuda.device_timed) == timed
    assert trace._PENDING == []


def test_counter_keys_are_unique_across_the_port():
    """harness.counters() keys a counter by function name and attribute:
    no other function of the port gives a span's or a launch's key."""
    for info in pkgutil.walk_packages(ecc_ldpc_tpu_torch.__path__,
                                      "ecc_ldpc_tpu_torch."):
        if not info.name.endswith("__main__"):
            importlib.import_module(info.name)
    owners = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("ecc_ldpc_tpu_torch.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            if inspect.isfunction(fn) and fn.__module__ == mod_name:
                for key, v in vars(fn).items():
                    if isinstance(v, int) and not isinstance(v, bool):
                        owners.setdefault(f"{attr}.{key}", set()).add(mod_name)
    mine = [f"span.{a}" for a in _span_counts()] + [
        f"{f}.{c}" for f in ("layered_decode_cuda", "layered_exact_cuda")
        for c in ("device_us", "device_timed")]
    for key in mine:
        assert len(owners.get(key, ())) == 1, (key, owners.get(key))
    assert owners["span.encode_n"] == {"ecc_ldpc_tpu_torch.trace"}
    assert owners["layered_exact_cuda.device_us"] == {
        "ecc_ldpc_tpu_torch.decode.layered_qc"}


def test_sweep_step_spans_nest_in_the_benchmark_span_and_count():
    """Under the benchmark's profiler window, Pipeline.counts on the CPU
    opens ldpc.encode, ldpc.channel and ldpc.tally inside its bench range,
    and harness.counters() sees each entry and its nanoseconds as deltas."""
    pipe = _pipeline()
    gen = torch.Generator()
    gen.manual_seed(2)
    msg, noise = pipe.draw(gen)
    tracer = Tracer(True, CPU)
    before = harness.counters()
    with tracer.window():
        for _ in range(2):
            with tracer.span("sweep.step"):
                pipe.counts(msg, noise, 2.0)
    delta = harness.counter_deltas(before)
    for s in ("encode", "channel", "tally"):
        assert delta[f"span.{s}_n"] == 2
        assert delta[f"span.{s}_ns"] > 0
    assert not any(k.startswith("span.retry") or k.startswith("span.decode")
                   for k in delta)
    inside = _inside(_ranges(tracer.prof), "bench.sweep.step")
    assert inside == {"ldpc.encode": 2, "ldpc.channel": 2, "ldpc.tally": 2}
    assert not trace.recording()


B = 6


def _llr(b):
    llr = torch.zeros(b, 3)
    llr[:, 0] = torch.arange(b, dtype=torch.float32)
    return llr


def _stubs(bad=()):
    """(primary, fallback) stub decoders: the primary fails the frames in
    `bad` (their id rides in llr[:, 0]), the fallback fixes every frame."""
    def primary(llr):
        ids = llr[:, 0].long()
        ok = torch.ones(len(ids), dtype=torch.bool)
        ok[[i for i, f in enumerate(ids.tolist()) if f in bad]] = False
        return DecodeResult(bits=torch.zeros(len(ids), 3, dtype=torch.uint8),
                            ok=ok, iterations=torch.full((len(ids),), 5))

    def fallback(llr):
        n = llr.shape[0]
        return DecodeResult(bits=torch.ones(n, 3, dtype=torch.uint8),
                            ok=torch.ones(n, dtype=torch.bool),
                            iterations=torch.full((n,), 7))
    return primary, fallback


@pytest.mark.parametrize("bad", [(), (1, 4)])
def test_retry_spans(bad):
    """retry.ok_read on every batch, retry.dispatch on the batch with
    failed frames only, both inside the benchmark's decode range; the
    result is the wrapper's as before."""
    dec = with_retry(*_stubs(bad))
    tracer = Tracer(True, CPU)
    before = harness.counters()
    with tracer.window():
        with tracer.span("sweep.decode"):
            res = dec(_llr(B))
    delta = harness.counter_deltas(before)
    assert delta["span.retry_ok_read_n"] == 1
    assert delta["span.retry_ok_read_ns"] > 0
    assert delta.get("span.retry_dispatch_n", 0) == (1 if bad else 0)
    assert (delta.get("span.retry_dispatch_ns", 0) > 0) == bool(bad)
    want = {"ldpc.retry.ok_read": 1}
    if bad:
        want["ldpc.retry.dispatch"] = 1
    assert _inside(_ranges(tracer.prof), "bench.sweep.decode") == want
    assert res.ok.all()
    assert res.bits[:, 0].tolist() == [int(i in bad) for i in range(B)]
    assert res.iterations.tolist() == [12 if i in bad else 5
                                       for i in range(B)]


SYNTHETIC = {
    # metric: (record, value)
    "decode_prepare_us": (
        {"kind": "decode", "requests": 10,
         "counters": {"span.decode_prepare_n": 10,
                      "span.decode_prepare_ns": 9_000_000}}, 900.0),
    "retry_dispatch_us": (
        {"kind": "sweep", "requests": 8,
         "counters": {"span.retry_dispatch_n": 6,
                      "span.retry_dispatch_ns": 9_600_000}}, 1200.0),
    "encode_host_ms": (
        {"kind": "sweep", "requests": 4,
         "counters": {"span.encode_n": 4, "span.encode_ns": 190_000_000}},
        47.5),
    "k1c_ms": (
        {"kind": "sweep", "requests": 10,
         "counters": {"layered_exact_cuda.device_us": 27_000,
                      "layered_exact_cuda.device_timed": 9,
                      "layered_exact_cuda.launches": 10}}, 3.0),
}


@pytest.mark.parametrize("metric", sorted(SYNTHETIC))
def test_reader(metric):
    read = harness.reader(metric)
    record, value = SYNTHETIC[metric]
    assert read(record) == pytest.approx(value)
    # the parent's record: the port's other counters moved, not these
    assert read({**record, "counters": {"layered_decode_cuda.launches": 3}}) \
        is None
    assert read({**record, "counters": {}}) is None
    other = "sweep" if record["kind"] == "decode" else "decode"
    assert read({**record, "kind": other}) is None


def test_new_metrics_name_their_cells():
    bench = harness.load_benchmark()
    cells = {m["name"]: m.get("workloads") for m in bench["per_layer"]}
    assert cells["decode_prepare_us"] == ["dvbs2_64800_r12.decode25",
                                          "nr5g_bg1_z384.decode25"]
    assert cells["encode_host_ms"] == ["dvbs2_64800_r12.sweep_retry",
                                       "nr5g_bg1_z384.sweep_et"]
    assert cells["retry_dispatch_us"] == cells["k1c_ms"] == [
        "dvbs2_64800_r12.sweep_retry"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _direct_ms(fn, reps=3) -> float:
    """Median device time of fn() from events around it, the profiler off;
    each behind a launch still running, so that its host work before the
    launch is hidden."""
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        fn()
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["K1a", "K1c"])
def test_launch_device_time_resolves_without_a_sync(card, wrapper,
                                                    monkeypatch):
    """Each launch under a profiler leaves an event pair; a later span takes
    it once done and never waits for it; device_us / device_timed agrees
    with the same launch timed directly."""
    from ecc_ldpc_tpu_torch.codes.registry import get_code
    from ecc_ldpc_tpu_torch.decode.api import choose_graph

    graph = choose_graph(get_code("dvbs2/16200/12"), "layered/spa/10")
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    llr = 1.0 + 2.0 * torch.randn(2048, graph.n, generator=gen, device=card)
    fn, call = {
        "K1a": (layered_decode_cuda, lambda: layered_decode_cuda(
            graph, llr, alpha=0.8125, max_iters=25, early_term=False)),
        "K1c": (layered_exact_cuda, lambda: layered_exact_cuda(
            graph, llr, max_iters=10, early_term=False, cn="spa")),
    }[wrapper]
    call()
    direct = _direct_ms(call)

    def refuse(*a, **k):
        raise AssertionError("a synchronisation while resolving")

    trace._PENDING.clear()
    us0, n0, launches0 = fn.device_us, fn.device_timed, fn.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]):
        call()
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", refuse)
            m.setattr(torch.cuda.Event, "synchronize", refuse)
            m.setattr(torch.cuda.Event, "wait", refuse)
            call()  # its prepare span meets the first pair, maybe pending
            assert fn.device_timed - n0 <= 1
            assert len(trace._PENDING) >= 1
        torch.cuda.synchronize(card)
        with trace.span("tally"):
            pass
        assert trace._PENDING == []
    assert fn.launches - launches0 == 2
    assert fn.device_timed - n0 == 2
    mean_ms = (fn.device_us - us0) / (fn.device_timed - n0) / 1e3
    assert mean_ms == pytest.approx(direct, rel=0.1, abs=0.2)


def test_chrome_trace_carries_the_spans(tmp_path):
    """The CLI's --profile-dir window turns the spans on: the exported
    trace names them."""
    import json

    from ecc_ldpc_tpu_torch.bench.profile import trace as profile_dir

    pipe = _pipeline()
    gen = torch.Generator()
    gen.manual_seed(4)
    with profile_dir(tmp_path) as path:
        pipe.counts(*pipe.draw(gen), 2.0)
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"ldpc.encode", "ldpc.channel", "ldpc.tally"} <= names


def test_spans_survive_an_exception():
    """A span left by an exception closes its range and still counts."""
    before = _span_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with contextlib.suppress(ValueError), trace.span("encode"):
            raise ValueError
    assert _span_counts()["encode_n"] == before["encode_n"] + 1
    assert _span_counts()["encode_ns"] > before["encode_ns"]
