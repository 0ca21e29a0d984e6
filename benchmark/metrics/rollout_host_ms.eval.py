"""Mean host time to queue one chunk's rollout (a step of ``evaluate.sample_chunks``) (ms)."""
from benchmark import common


def read(data):
    return common.span_mean_ms(data, "rollout_host")
