"""flush_ms: the benchmark's own span around each ``StreamService.flush()``
call, ended by ``torch.cuda.synchronize()``: all flush time over all
flushes of a segment of its own, in milliseconds."""


def read(obs):
    spans = obs.spans_s.get("flush")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
