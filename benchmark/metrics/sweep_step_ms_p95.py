"""sweep_step_ms_p95: the 95th percentile (nearest rank) over every step
of the window, host clock from the call to the end of the counters' read,
in ms."""
from benchmark.stats import percentile


def read(record):
    if record["kind"] != "sweep":
        return None
    return percentile(record["request_ms"], 95)
