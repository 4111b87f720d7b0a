"""device_idle_pct.decode: the share of the traced window in which no
device activity ran, in the decode cells, in %. Nothing when the profiler
recorded no device work for some call."""


def read(record):
    trace = record.get("trace")
    if record["kind"] != "decode" or not trace:
        return None
    if trace["requests_traced"] < record["requests"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
