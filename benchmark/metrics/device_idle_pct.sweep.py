"""device_idle_pct.sweep: the share of the traced window in which no device
activity ran, in the sweep cells, in %. Nothing when the profiler recorded
no device work for some step."""


def read(record):
    trace = record.get("trace")
    if record["kind"] != "sweep" or not trace:
        return None
    if trace["requests_traced"] < record["requests"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
