"""Share of the profiled window's device idle time (its gaps) whose gap began while the program's innermost open span was a ``savp.step`` (%)."""
from benchmark import spans


def read(data):
    return spans.idle_share_pct(data, "savp.step")
