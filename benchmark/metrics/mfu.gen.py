"""Counted model FLOPs (``benchmark/models/<model>.py``, ``benchmark/counts.py``) of the window's units over its time, as a share of the configuration's peak (%)."""
from benchmark import common


def read(data):
    return common.mfu_pct(data)
