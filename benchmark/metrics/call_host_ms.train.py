"""Mean host time of a ``MultiStep`` call, from its start until it returns (the batch and noise copied in, the graph replay queued), before any wait for the device (ms)."""
from benchmark import common


def read(data):
    return common.span_mean_ms(data, "call_host")
