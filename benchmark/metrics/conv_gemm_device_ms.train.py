"""Device time of the cuDNN and cuBLAS kernels and their layout transforms per train step in the profiled window (ms)."""
from benchmark import common


def read(data):
    events = common.group_events(data["trace"])["conv_gemm"]
    steps = data["trace"]["units"] * data["cell"].k
    return 1e3 * sum(events) / steps
