"""``device_idle.decode``: the share of the traced decode window in
which no operation runs on the card (the union of the profiler's device
intervals), in percent."""


def read(t):
    return 100 * (1 - t.busy_s / t.window_s)
