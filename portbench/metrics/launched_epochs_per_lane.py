"""launched_epochs_per_lane (epochs/lane): the lanes of every float32 step
(#2, semi or adjoint) that the batch program launched, from the program's
own counts (``count("launch", ...)`` in the kernel wrappers, kept in the
innermost open span): summed over ``datagen.run_batch`` and the spans
under it inside the traced window, over the lanes that the window's
``datagen.batch`` spans drew.  The epochs of #2 work a drawn lane costs,
with the stopped lanes that pad each compaction bucket.  A program without
spans, or whose spans hold no counts, reads nothing."""

from portbench.metrics.lane_epochs_per_s import OPT_KINDS
from portbench.metrics.sampler_s_per_batch import program_spans, under


def read(r):
    inside, by_id = program_spans(r)
    drawn = sum(s["attrs"].get("lanes", 0) for s in inside
                if s["name"] == "datagen.batch")
    launched = 0
    for s in inside:
        if s["name"] != "datagen.run_batch" and not under(
                s, "datagen.run_batch", by_id):
            continue
        for (name, key), n in s.get("counts", {}).items():
            key = dict(key)
            if name == "launch" and key.get("kind") in OPT_KINDS:
                launched += n * key["lanes"]
    if not drawn or not launched:
        return None
    return launched / drawn
