"""answers_per_s: answers completed in the measured window over the
window's seconds (from its first call to the end of its last cycle)."""
from dsgbench.stats import rate


def read(window):
    return rate(window.answers, window.seconds)
