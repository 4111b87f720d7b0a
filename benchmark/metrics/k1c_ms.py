"""k1c_ms: kernel K1c's device time per sweep step, in ms: the mean device
time of its launches that the port timed with CUDA events
(layered_exact_cuda.device_us over .device_timed, resolved without a
synchronisation while the profiler recorded) times its launches in the
window, over the window's steps. Independent of the profiler's kernel
records. Nothing where no launch was timed (no fallback launch, or a port
without the counters)."""

US, TIMED = "layered_exact_cuda.device_us", "layered_exact_cuda.device_timed"
LAUNCHES = "layered_exact_cuda.launches"


def read(record):
    c = record.get("counters", {})
    if record["kind"] != "sweep" or not c.get(TIMED):
        return None
    mean_us = c.get(US, 0) / c[TIMED]
    return mean_us * c.get(LAUNCHES, 0) / record["requests"] / 1e3
