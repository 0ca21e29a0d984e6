"""K1-K3 (CDNA, LayerNorm gates, compositing) in the profiled window: their least time, the bytes counted by the model's ``benchmark/models/<model>.py`` (formulas of ``benchmark/counts.py``) over the HBM rate, over their device time (%)."""
from benchmark import common


def read(data):
    return common.hand_kernels_roofline_pct(data)
