"""encode_host_ms: the encoder's host time per sweep step (the port's span
encode in sim/runner.Pipeline.llr, around the encoder's call: its
launches), its host nanoseconds over the window's steps, in ms. Nothing
where the span did not run (a port without it)."""

N, NS = "span.encode_n", "span.encode_ns"


def read(record):
    c = record.get("counters", {})
    if record["kind"] != "sweep" or not c.get(N):
        return None
    return c.get(NS, 0) / record["requests"] / 1e6
