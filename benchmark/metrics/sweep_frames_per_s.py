"""sweep_frames_per_s: frames through the sweep step (encode, channel,
decode with retry, tally and its host read) over the whole window (host
clock)."""


def read(record):
    if record["kind"] != "sweep":
        return None
    return record["frames"] / record["window_s"]
