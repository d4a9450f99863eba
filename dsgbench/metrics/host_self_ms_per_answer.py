"""host_self_ms_per_answer: the host's own time in an answer, in
milliseconds: each root span of the program's entry points (``pbahmani``,
``cbds_p``, recorded under ``repro_torch.obs.trace.capture()``) less the
time its ``host_sync`` spans cover, as a mean over the answers. Python,
launches and the handling of what was read back, but no wait for the card.
It holds the spans' own host time too (what capture costs: an answer's
latency with capture less without it, which ``entry_spans.py`` reads).
Reads ``obs.spans``; None where the program recorded no span."""
from dsgbench.spans import mean_of


def read(obs):
    return mean_of(obs, lambda total_ms, sync_ms, syncs: total_ms - sync_ms)
