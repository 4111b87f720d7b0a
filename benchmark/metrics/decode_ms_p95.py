"""decode_ms_p95: the 95th percentile (nearest rank) over every decode call
of the window, each from a CUDA event before the call to one after it that
the host waits on, in ms."""
from benchmark.stats import percentile


def read(record):
    if record["kind"] != "decode":
        return None
    return percentile(record["request_ms"], 95)
