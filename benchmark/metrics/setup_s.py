"""setup_s: host seconds from the process's start to the window's: imports,
the codes, the kernels' build (first run in a checkout) and load, the
inputs, the warm-up."""


def read(record):
    return record["setup_s"]
