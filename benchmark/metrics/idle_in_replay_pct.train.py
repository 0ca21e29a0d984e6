"""Share of the profiled window's device idle time (its gaps) whose gap began while the program's innermost open span was ``multistep.replay`` (%)."""
from benchmark import spans


def read(data):
    return spans.idle_share_pct(data, "multistep.replay")
