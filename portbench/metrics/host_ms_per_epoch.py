"""host_ms_per_epoch (ms/epoch): the host's milliseconds an epoch of the
float32 batch program, from the program's spans: the ``opt.stage`` spans
under ``datagen.run_batch`` inside the traced window, less their
``opt.sync`` children (the host's waits for the done flags), over the
epochs the stages ran.  Above the card's time an epoch, the loop is paced
by its launches.  The profiler's own cost a host op is in it."""

from portbench.metrics.sampler_s_per_batch import program_spans, seconds, under


def epoch_loop(r):
    """(the batch program's ``opt.stage`` spans in the window, their
    ``opt.sync`` children, the epochs the stages ran)."""
    inside, by_id = program_spans(r)
    stages = [s for s in inside if s["name"] == "opt.stage"
              and under(s, "datagen.run_batch", by_id)]
    ids = {s["id"] for s in stages}
    syncs = [s for s in inside
             if s["name"] == "opt.sync" and s["parent"] in ids]
    return stages, syncs, sum(s["attrs"].get("epochs", 0) for s in stages)


def read(r):
    stages, syncs, epochs = epoch_loop(r)
    if not epochs:
        return None
    return 1e3 * (seconds(stages) - seconds(syncs)) / epochs
