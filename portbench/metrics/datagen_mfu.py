"""datagen_mfu (%): the operations the float32 batch program needed in the
traced window, each at its peak rate, over the window's seconds on the host
clock: a step (#2, semi or adjoint) for every epoch each lane ran and one
analysis (#1) for every lane (``r.needed``, from the program's results;
operations from ``harness/roofline.py``).  Launches that carry stopped
lanes are not counted, so wasted work cannot raise it.  The whole batch's
share of the card's peak, it still reads where a kernel leaves the path and
its roofline falls silent."""

from portbench.harness import roofline


def read(r):
    if not r.needed or r.window_s <= 0:
        return None
    ideal = sum(lanes * roofline.flops_per_lane(n, refine, kind)
                / roofline.peak_flops(kind)
                for (kind, n, refine), lanes in r.needed.items())
    return 100.0 * ideal / r.window_s
