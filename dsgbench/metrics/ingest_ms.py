"""ingest_ms: the benchmark's own span around each
``StreamService.ingest_many()`` call, ended by ``torch.cuda.synchronize()``
(so it holds the device work the call queued): all ingest time over all
rounds of a segment of its own, in milliseconds."""


def read(obs):
    spans = obs.spans_s.get("ingest_many")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
