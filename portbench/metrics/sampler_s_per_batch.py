"""sampler_s_per_batch (s/batch): the host sampler's seconds a batch, from
the program's own spans (``openpystruct_tpu_torch/utils/profiling.py``,
recorded while the traced window's profiler runs): the ``datagen.sample``
spans inside the window (``sample_scenarios`` with its copies to the
card), summed, over their number.  A program without spans reads
nothing."""

from openpystruct_tpu_torch.utils import profiling


def program_spans(r):
    """(the program's closed spans inside the traced window, every span
    recorded by id); ([], {}) where the program records none."""
    spans = getattr(profiling, "spans", None)
    if spans is None or r.window_s <= 0:
        return [], {}
    every = spans()
    lo, hi = r.start, r.start + r.window_s
    inside = [s for s in every
              if s["t1"] is not None and lo <= s["t0"] and s["t1"] <= hi]
    return inside, {s["id"]: s for s in every}


def under(s, name, by_id):
    """Whether span ``s`` lies inside a span called ``name``."""
    while s["parent"] is not None and s["parent"] in by_id:
        s = by_id[s["parent"]]
        if s["name"] == name:
            return True
    return False


def seconds(spans):
    return sum(s["t1"] - s["t0"] for s in spans)


def read(r):
    sample = [s for s in program_spans(r)[0] if s["name"] == "datagen.sample"]
    return seconds(sample) / len(sample) if sample else None
