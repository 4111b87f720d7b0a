"""decode_prepare_us: the decode wrapper's host work before each kernel
launch (the port's span decode.prepare in decode/layered_qc: input checks,
argument tensors, device tables, the launch plan and its allocations, the
library), its host nanoseconds over its entries in the window, in us.
Nothing where the span did not run (a port without it)."""

N, NS = "span.decode_prepare_n", "span.decode_prepare_ns"


def read(record):
    c = record.get("counters", {})
    if record["kind"] != "decode" or not c.get(N):
        return None
    return c.get(NS, 0) / c[N] / 1e3
