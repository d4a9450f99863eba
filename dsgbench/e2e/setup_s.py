"""setup_s: from the start of the benchmark's process to the first timed
answer: imports, inputs drawn on the card, the program's set-up, kernel
builds (on a checkout's first run) and warm-up."""


def read(window):
    return window.setup_s
