"""k1a_roofline: kernel K1a's share of its roofline in the decode cells, in
%: the least time an H100 could take for the decodes of the window (the
frozen bound of benchmark/roofline.py, for the iterations each batch ran)
over the device time the profiler recorded for K1a (layered_qc_kernel).
Nothing when the trace lacks a K1a launch for some call."""
from benchmark import roofline

KERNEL = "layered_qc_kernel"


def read(record):
    trace = record.get("trace")
    if record["kind"] != "decode" or record.get("rule") != "minsum" or not trace:
        return None
    launches = [v for k, v in trace["kernels"].items() if KERNEL in k]
    if sum(c for c, _ in launches) != record["requests"]:
        return None
    bound = sum(roofline.decode_bound(record["n"], record["edges"],
                                      record["batch"], it, "minsum",
                                      record["m"])[0]
                for it in record["iteration_sums"])
    return 100.0 * bound / sum(s for _, s in launches)
