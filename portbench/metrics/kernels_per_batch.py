"""kernels_per_batch (kernels/batch): operations on the device that the
profiler saw in the traced window, over the window's batches."""


def read(r):
    if r.profile is None or not r.batches or r.profile["n_device"] == 0:
        return None
    return r.profile["n_device"] / len(r.batches)
