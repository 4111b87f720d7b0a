"""sweep_decode_ms: device time of the pipeline's decode (the primary, the
retry wrapper's host read of the ok flags, the fallback) per step, from
CUDA events around it, mean over the window's steps, in ms."""
import statistics


def read(record):
    spans = record.get("spans_ms", {}).get("sweep.decode")
    if record["kind"] != "sweep" or not spans:
        return None
    return statistics.fmean(spans)
