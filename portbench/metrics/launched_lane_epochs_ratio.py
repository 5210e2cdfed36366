"""launched_lane_epochs_ratio (x): the lanes of every float32 step (#2)
launched in the traced window over the lane-epochs the batch program needed
(``lane_epochs_per_s``'s count): the work the compaction cascade spends on
lanes that have stopped, which pad each power-of-two bucket until the next
stage; 1 where no launch carries a stopped lane."""

from portbench.metrics.lane_epochs_per_s import OPT_KINDS, lane_epochs


def read(r):
    launched = sum(count * lanes for (kind, lanes, _, _), count
                   in r.launches.items() if kind in OPT_KINDS)
    if not launched or not lane_epochs(r):
        return None
    return launched / lane_epochs(r)
