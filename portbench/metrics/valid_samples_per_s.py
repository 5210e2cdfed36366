"""valid_samples_per_s (samples/s): valid lanes over the window's seconds,
every batch counted by the share of its time inside the window."""


def read(r):
    if not r.batches or r.window_s <= 0:
        return None
    return sum(b.valid * r.in_window(b) for b in r.batches) / r.window_s
