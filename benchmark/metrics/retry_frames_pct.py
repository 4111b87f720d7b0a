"""retry_frames_pct: frames the retry wrapper sent to the fallback decoder
(the layered exact-BP kernel K1c's frames counter) over the frames of the
window, in %."""

COUNTER = "layered_exact_cuda.frames"


def read(record):
    if record["kind"] != "sweep" or not record.get("retry"):
        return None
    if record["device"] != "cuda":
        return None
    return 100.0 * record["counters"].get(COUNTER, 0) / record["frames"]
