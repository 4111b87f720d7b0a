"""decode_host_us: the median host time of a decode call, from the call to
its return (checks, allocations, the launch), in us."""
import statistics


def read(record):
    if record["kind"] != "decode":
        return None
    return statistics.median(record["host_us"])
