"""frontend_ms: device time of the pipeline's encoder and channel
(Pipeline.llr) per step, from CUDA events around it, mean over the
window's steps, in ms."""
import statistics


def read(record):
    spans = record.get("spans_ms", {}).get("sweep.llr")
    if record["kind"] != "sweep" or not spans:
        return None
    return statistics.fmean(spans)
