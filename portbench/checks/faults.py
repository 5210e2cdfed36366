"""Faults planted under the datagen entry's timed path, to show that the
comparison catches them (``portbench/tests/test_portbench_faults.py`` on
the CPU, ``calibrate.py --fault`` on the card):

- ``unchanged``: the Adam step returns the state it was given;
- ``half``: the step leaves the second half of the batch's lanes out,
  their state returned as given;
- ``altered``: the final analysis returns each lane's moments shifted by
  one element, an answer altered where it is produced (an off-by-one).

Each wraps a name that ``opt/beam_opt.py`` launches through and puts it
back on exit.  (The fourth fault of the kind, an exchange between chips
left out, has no place in a one-card cell.)
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(fault: str):
    from openpystruct_tpu_torch.opt import beam_opt

    name = "beam_analysis" if fault == "altered" else "beam_opt_step"
    orig = getattr(beam_opt, name)

    def unchanged(I, mu, nu, *args, **kw):
        _, _, _, stats = orig(I, mu, nu, *args, **kw)
        return I.clone(), mu.clone(), nu.clone(), stats

    def half(I, mu, nu, *args, **kw):
        I_n, mu_n, nu_n, stats = orig(I, mu, nu, *args, **kw)
        h = I.shape[0] // 2
        for new, old in ((I_n, I), (mu_n, mu), (nu_n, nu)):
            new[h:] = old[h:]
        return I_n, mu_n, nu_n, stats

    def altered(*args, **kw):
        import torch

        u, V, M, piv = orig(*args, **kw)
        return u, V, torch.roll(M, 1, dims=-1), piv

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(beam_opt, name, dict(unchanged=unchanged, half=half,
                                 altered=altered)[fault])
    try:
        yield
    finally:
        setattr(beam_opt, name, orig)
