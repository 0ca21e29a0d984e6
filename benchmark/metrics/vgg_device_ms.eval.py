"""Mean device time of the program's ``metric.vgg_csim`` span (VGG16 cosine of a chunk in ``BestOfN.update``), from its own CUDA events, in the profiled window (ms)."""
from benchmark import spans


def read(data):
    return spans.device_mean_ms(data, "metric.vgg_csim")
