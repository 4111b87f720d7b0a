"""decode_mbps: message bits of every frame decoded in the window, over the
whole window (host clock), in Mbit/s."""


def read(record):
    if record["kind"] != "decode":
        return None
    return record["frames"] * record["k"] / record["window_s"] / 1e6
