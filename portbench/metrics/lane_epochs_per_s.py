"""lane_epochs_per_s (lane-epochs/s): the epochs of the float32 batch
program's lanes (``run_batch``'s ``result.n_epochs``, before any rescue
merges), summed over the traced window's batches, over its seconds."""

OPT_KINDS = ("semi", "adjoint")


def lane_epochs(r):
    return sum(v for (kind, _, _), v in r.needed.items() if kind in OPT_KINDS)


def read(r):
    if not lane_epochs(r) or r.window_s <= 0:
        return None
    return lane_epochs(r) / r.window_s
