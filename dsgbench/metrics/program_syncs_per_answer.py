"""program_syncs_per_answer: the ``host_sync`` spans below each root span of
the program's entry points, as a mean over the answers: the host syncs
counted where they happen (``host_syncs_per_answer`` counts the same from
torch's sync debug mode). Reads ``obs.spans``; None where the program
recorded no span."""
from dsgbench.spans import mean_of


def read(obs):
    return mean_of(obs, lambda total_ms, sync_ms, syncs: syncs)
