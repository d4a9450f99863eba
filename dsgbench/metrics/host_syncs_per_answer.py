"""host_syncs_per_answer: the synchronising CUDA calls torch reported under
``set_sync_debug_mode("warn")`` in a segment of its own, over the answers
completed in it."""


def read(obs):
    if obs.syncs is None or not obs.answers_synced:
        return None
    return obs.syncs / obs.answers_synced
