"""valid_share (frac): valid lanes over lanes drawn, over every batch of
the window."""


def read(r):
    lanes = sum(b.lanes for b in r.batches)
    return sum(b.valid for b in r.batches) / lanes if lanes else None
