"""Mean host time of the program's ``savp.step`` span, one generator timestep queued, in the profiled window (ms)."""
from benchmark import spans


def read(data):
    return spans.mean_ms(data, "savp.step")
