"""sync_wait_ms_per_epoch (ms/epoch): the host's milliseconds an epoch of
the float32 batch program spent waiting for the card's done flags, from
the program's spans: the ``opt.sync`` spans of ``host_ms_per_epoch``'s
stages, over the same epochs.  Read beside ``host_ms_per_epoch``: the two
add up to the loop's time an epoch, so a faster host in a loop the card
paces moves time from that metric to this one."""

from portbench.metrics.host_ms_per_epoch import epoch_loop
from portbench.metrics.sampler_s_per_batch import seconds


def read(r):
    _, syncs, epochs = epoch_loop(r)
    if not epochs:
        return None
    return 1e3 * seconds(syncs) / epochs
