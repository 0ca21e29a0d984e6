"""Mean host time a train call waits in ``next()`` on the port's ``DeviceFeeder``, over the window (ms)."""
from benchmark import common


def read(data):
    return common.span_mean_ms(data, "feeder_wait")
