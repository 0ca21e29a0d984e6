"""Mean device time of ``evaluate.BestOfN.update`` on a chunk, between CUDA events around it (ms)."""
from benchmark import common


def read(data):
    return common.span_mean_ms(data, "metrics_device")
