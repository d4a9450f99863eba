"""launches_per_answer: kernels, copies and memsets the card ran in the
traced window, over the answers completed in it. Read from the segment
profiled for the card's activity alone."""


def read(obs):
    r = obs.reading
    if r is None or not r.events or not obs.answers_profiled:
        return None
    return len(r.inside()) / obs.answers_profiled
