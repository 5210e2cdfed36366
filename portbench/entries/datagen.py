"""The datagen entry: ``openpystruct_tpu_torch.datagen.generate.generate_batch``
called as the command line's ``datagen`` calls it, batch after batch from
one ``torch.Generator`` seeded with ``--seed``, as ``generate_dataset``
advances it.

Set-up builds the kernels (the first run of a checkout compiles them into
``openpystruct_tpu_torch/ops/_build/``) and runs one whole batch, the
dataset's first, which warms every shape the window uses.  The window
calls batches back to back until the host clock passes its end; the batch
then running is finished and counts by the share of its time inside the
window.  After each batch the rows of ``sample_per_batch`` lanes drawn
from the seed are gathered on the card; once the window has closed they
are judged against the plain reference (``portbench/reference``).

The traffic's ``host_threads`` fixes the host's intra-op threads (the
sampler's sorts run there), so that the host's load is the same in every
run.

With ``--trace 1`` the window runs under torch.profiler, and wrappers in
the benchmark's own code record, around the program's calls: each kernel
launch's lanes and mode (the names ``opt/beam_opt.py`` launches through),
and the work the float32 batch program needed (``run_batch``'s result,
before any rescue merges): a step for every epoch each lane ran, one
analysis for every lane.
"""

from __future__ import annotations

import contextlib
import inspect
import time

import numpy as np

from portbench.harness.readings import Batch
from portbench.reference import judge as rj


class Session:
    def __init__(self, cell: dict, seed: int, device: str, trace: bool):
        import torch

        self.torch = torch
        self.cfg = cell["config"]
        self.traffic = cell["traffic"]
        self.opt = dict(self.cfg["optimizer"])
        if "grad_mode" in self.traffic:
            self.opt["grad_mode"] = self.traffic["grad_mode"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        self.lanes = int(self.traffic["lanes"])
        self.k = min(int(self.traffic["sample_per_batch"]), self.lanes)
        self.rng = np.random.default_rng([self.seed, 1])
        self.rows_by_batch = []      # sampled lanes of every batch drawn
        self.kept = []               # their rows, gathered on the card
        if "host_threads" in self.traffic:
            torch.set_num_threads(int(self.traffic["host_threads"]))

    # -- the program ------------------------------------------------------

    def _program(self):
        from openpystruct_tpu_torch.config import OptimizerConfig, ScenarioConfig

        sc = dict(self.cfg["scenario"])
        sc["fixed_roller_tags"] = tuple(sc["fixed_roller_tags"])
        scen = ScenarioConfig(**sc)
        opt = OptimizerConfig(**self.opt)
        dg = self.cfg["datagen"]
        rescue = self.traffic.get("rescue", dg["rescue"])
        return dict(scen_cfg=scen, opt_cfg=opt, refine=int(dg["refine"]),
                    pivot_tol=float(dg["pivot_tol"]), rescue=rescue,
                    device=self.device,
                    dtype=getattr(self.torch, dg["dtype"]))

    def setup(self) -> None:
        from openpystruct_tpu_torch.datagen import generate

        torch = self.torch
        if self.cfg["datagen"]["tf32"] is False:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.generate = generate
        self.kw = self._program()
        self.gen = torch.Generator().manual_seed(self.seed)
        self._batch(sample=False)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _batch(self, sample=True):
        """One batch; returns (lanes, valid lanes) once it is on the host."""
        batch = self.generate.generate_batch(self.gen, self.lanes, **self.kw)
        valid = int(batch.valid.sum())
        rows = (np.sort(self.rng.choice(self.lanes, self.k, replace=False))
                if sample else np.zeros(0, dtype=np.int64))
        self.rows_by_batch.append(rows)
        if sample:
            self.kept.append(_rows(self.torch, batch, rows))
        return batch.valid.shape[0], valid

    def window(self, seconds: float, r) -> None:
        with contextlib.ExitStack() as stack:
            if self.trace:
                from portbench.harness.trace import Profiler

                stack.enter_context(_wrappers(self, r))
                prof = stack.enter_context(Profiler())
            r.start = time.perf_counter()
            end = r.start + seconds
            while True:
                t0 = time.perf_counter()
                lanes, valid = self._batch()
                t1 = time.perf_counter()
                r.batches.append(Batch(t0, t1, lanes, valid))
                if t1 >= end:
                    break
            self._sync()
        r.window_s = (r.batches[-1].t1 - r.start) if self.trace else seconds
        if self.trace:
            r.profile = prof.summary()
            r.needed = {k: int(v) for k, v in r.needed.items()}

    # -- the comparison ----------------------------------------------------

    def check(self) -> dict:
        """Free the program's state, then judge the sampled rows."""
        torch = self.torch
        rows = {k: torch.cat([kp[k] for kp in self.kept]) for k in self.kept[0]}
        self.kept.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref_sc = rj.replay(self.seed, self.cfg, self.lanes,
                           self.rows_by_batch)
        ref = rj.reference_rows(ref_sc, self.cfg, self.opt, self.device)
        return rj.judge(rows, ref_sc, ref, self.opt)


def _rows(torch, batch, rows) -> dict:
    """The sampled lanes' rows of a batch, gathered on its device."""
    idx = torch.as_tensor(rows, device=batch.valid.device)
    sc, res = batch.scenario, batch.result
    sol = res.solution
    fields = dict(node_x=sc.node_x, roller_mask=sc.roller_mask,
                  point_loads=sc.point_loads, udl=sc.udl,
                  roller_order=sc.roller_order, force_order=sc.force_order,
                  I=res.I, I_solved=res.I_solved, u=sol.displacements,
                  V=sol.shear_forces, M=sol.bending_moments,
                  valid=batch.valid)
    return {k: v[idx] for k, v in fields.items()}


#: the kernel entry points ``opt/beam_opt.py`` launches through, with the
#: mode each launch runs in
_LAUNCHERS = ("beam_opt_step", "beam_analysis", "beam_opt_step_dd",
              "beam_analysis_dd")


@contextlib.contextmanager
def _wrappers(session, r):
    """Wrap the program's launch entry points and batch program by name
    for the traced window, and put them back after."""
    from openpystruct_tpu_torch.opt import beam_opt

    gen = session.generate
    refine = int(session.cfg["datagen"]["refine"])
    saved = {name: getattr(beam_opt, name) for name in _LAUNCHERS}
    saved_run = gen.run_batch
    signature = inspect.signature(saved_run)

    def counted(name, fn):
        def launch(I, *args, **kw):
            if name == "beam_opt_step":
                kind = "semi" if kw.get("grad_semi", True) else "adjoint"
            else:
                kind = dict(beam_analysis="analysis", beam_opt_step_dd="opt_dd",
                            beam_analysis_dd="analysis_dd")[name]
            key = (kind, int(I.shape[0]), int(I.shape[1]) + 1,
                   int(kw.get("refine", refine)) if kind in
                   ("semi", "adjoint", "analysis") else 0)
            r.launches[key] = r.launches.get(key, 0) + 1
            return fn(I, *args, **kw)
        return launch

    def run_batch(*args, **kw):
        out = saved_run(*args, **kw)
        a = signature.bind(*args, **kw)
        a.apply_defaults()
        p = a.arguments
        n, lanes = int(p["scenario"].node_x.shape[-1]), int(out.valid.shape[0])
        step = "semi" if p["opt_cfg"].grad_mode == "semi" else "adjoint"
        for key, count in (((step, n, p["refine"]), out.result.n_epochs.sum()),
                           (("analysis", n, p["refine"]), lanes)):
            r.needed[key] = r.needed.get(key, 0) + count
        return out

    for name, fn in saved.items():
        setattr(beam_opt, name, counted(name, fn))
    gen.run_batch = run_batch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(beam_opt, name, fn)
        gen.run_batch = saved_run
