"""device_idle_share (frac): 1 - (the union of the device's busy
intervals) / (the traced window), from torch.profiler; an upper bound, as
the profiler's own host cost widens the gaps."""


def read(r):
    if r.profile is None or r.window_s <= 0 or r.profile["busy_s"] <= 0:
        return None
    return 1.0 - r.profile["busy_s"] / r.window_s
