"""Mean host time to queue one request's rollout (``forward(train=False)``), up to the wait for its frames (ms)."""
from benchmark import common


def read(data):
    return common.span_mean_ms(data, "rollout_host")
