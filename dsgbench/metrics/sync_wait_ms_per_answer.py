"""sync_wait_ms_per_answer: the time the host sat blocked on the card in an
answer, in milliseconds: the ``host_sync`` spans below each root span of
the program's entry points, summed, as a mean over the answers. Reads
``obs.spans``; None where the program recorded no span."""
from dsgbench.spans import mean_of


def read(obs):
    return mean_of(obs, lambda total_ms, sync_ms, syncs: sync_ms)
