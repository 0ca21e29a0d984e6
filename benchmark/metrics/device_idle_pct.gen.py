"""Share of the profiled window's wall time in which no operation ran on the device (%)."""
from benchmark import common


def read(data):
    return common.device_idle_pct(data)
