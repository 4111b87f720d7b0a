"""retry_dispatch_us: the retry wrapper's turnaround per sweep step (the
port's span retry.dispatch in decode/api.with_retry, entered on steps with
failed frames: the failed rows' index, its copy to the card, the gather,
the fallback's prepare and launch, while the card has nothing queued), its
host nanoseconds over the window's steps, in us. Nothing where the span did
not run (no retry, no failed frame, or a port without it)."""

N, NS = "span.retry_dispatch_n", "span.retry_dispatch_ns"


def read(record):
    c = record.get("counters", {})
    if record["kind"] != "sweep" or not c.get(N):
        return None
    return c.get(NS, 0) / record["requests"] / 1e3
