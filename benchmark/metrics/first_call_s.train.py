"""Set-up time of the program's ``MultiStep``: its eager first call (``multistep.eager``) and its graph capture (``multistep.capture``), whole, not cut to the profiled window (s)."""
from benchmark import spans


def read(data):
    return spans.setup_s(("multistep.eager", "multistep.capture"))
