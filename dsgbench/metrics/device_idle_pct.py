"""device_idle_pct: the share of the traced window in which no kernel, copy
or memset ran on the card (1 minus the union of the device's busy intervals
over the window), in percent. Read from the segment profiled for the card's
activity alone, so the profiler adds no host time to the idle share."""


def read(obs):
    r = obs.reading
    if r is None or not r.events or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.window_s)
