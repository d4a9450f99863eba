"""answer_p95_ms: the 95th percentile of the latency of every answer in the
measured window, in milliseconds (host clock around each call, which ends
in the host read of its answer)."""
from dsgbench.stats import percentile


def read(window):
    if not window.latencies_s:
        return None
    return 1e3 * percentile(window.latencies_s, 95)
