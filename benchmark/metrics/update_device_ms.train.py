"""Device time of a train step's update (both Adams and the spectral ``u`` copy), from the phase events captured in the program's CUDA graph: the last replay's mean over its steps (ms)."""
from benchmark import spans


def read(data):
    return spans.phase_mean_ms("update")
