"""Mean host time of the program's ``multistep.replay`` span (``graph.replay()`` and the launch-count update) a train call in the profiled window (ms)."""
from benchmark import spans


def read(data):
    return spans.mean_ms(data, "multistep.replay")
