#!/usr/bin/env python3
"""The frame path's float32 behaviour in both packages on the CPU, on the
same inputs: the JAX package (the reference) and the PyTorch port.

    JAX_PLATFORMS=cpu python3 tools/frame_cpu_compare.py [--lanes 256]
        [--checked-lanes 2048]

1. float32 banded solve error: per topology (1x10, 3x3, 10x1, 10x10,
   20x20), ``--lanes`` lognormal-I lanes (sigma 0.5 around I0, numpy
   ``default_rng(0)``), each package's float32 ``solve_frame_banded``
   against the port's float64 dense solve: the per-lane error (max |du|
   over the lane's max |u|) at the median and the worst lane, and each
   package's min pivot.
2. ``solve_frame_checked(tol=1e-4)`` on ``--checked-lanes`` 3x4 lanes with
   70-95% of the members at the 1e-8 clamp (``default_rng(11)``): lanes
   escalated, lanes certified, and the certified lanes whose error to the
   float64 dense solve exceeds tol (est, pivot, error), per package.

The JAX package runs as its tests run it, with ``jax_enable_x64`` off.
"""

import argparse
import os
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from openpystruct_tpu.config import FrameConfig as JFrameConfig  # noqa: E402
from openpystruct_tpu.fem import frame as jframe  # noqa: E402
from openpystruct_tpu.fem import frame_banded as jbanded  # noqa: E402
from openpystruct_tpu_torch.config import FrameConfig  # noqa: E402
from openpystruct_tpu_torch.fem import frame as tframe  # noqa: E402
from openpystruct_tpu_torch.fem import frame_banded as tbanded  # noqa: E402

CFG, JCFG = FrameConfig(), JFrameConfig()


def lane_err(x, ref):
    B = ref.shape[0]
    d = np.abs(np.asarray(x, np.float64) - ref).reshape(B, -1).max(1)
    return d / np.abs(ref).reshape(B, -1).max(1)


def truth(I, ts):
    return tframe.solve_frame(torch.tensor(I, dtype=torch.float64), ts, CFG,
                              torch.float64, method="dense"
                              ).displacements.numpy()


def accuracy(lanes):
    print(f"float32 banded solve vs float64 dense, {lanes} lanes")
    for nb, ns in ((1, 10), (3, 3), (10, 1), (10, 10), (20, 20)):
        js = jframe.build_frame(nb, ns, JCFG)
        ts = tframe.build_frame(nb, ns, CFG, device="cpu")
        rng = np.random.default_rng(0)
        I = (np.exp(rng.normal(size=(lanes, js.num_elems)) * 0.5)
             * CFG.I0).astype(np.float32)
        jsol, jpiv = jax.jit(jax.vmap(lambda i: jbanded.solve_frame_banded(
            i, js, JCFG, jnp.float32)))(I)
        tsol, tpiv = tbanded.solve_frame_banded(torch.tensor(I), ts, CFG)
        ref = truth(I, ts)
        ej = lane_err(jsol.displacements, ref)
        et = lane_err(tsol.displacements.numpy(), ref)
        print(f"  {nb}x{ns}: JAX median {np.median(ej):.2e} worst "
              f"{ej.max():.2e} min pivot {float(jnp.min(jpiv)):.3e} | port "
              f"median {np.median(et):.2e} worst {et.max():.2e} min pivot "
              f"{float(tpiv.min()):.3e}")


def checked(lanes, tol=1e-4):
    js = jframe.build_frame(3, 4, JCFG)
    ts = tframe.build_frame(3, 4, CFG, device="cpu")
    E = js.num_elems
    rng = np.random.default_rng(11)
    I = np.exp(rng.normal(size=(lanes, E)) * 0.5) * CFG.I0
    for k in range(lanes):
        frac = 0.7 + 0.25 * rng.random()
        I[k, rng.choice(E, size=int(frac * E), replace=False)] = 1e-8
    I = I.astype(np.float32)
    print(f"solve_frame_checked(tol={tol:g}), {lanes} 3x4 lanes, 70-95% of "
          "the members at 1e-8")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsol, jinfo = jbanded.solve_frame_checked(jnp.asarray(I), js, JCFG,
                                                  tol=tol)
        tsol, tinfo = tbanded.solve_frame_checked(torch.tensor(I), ts, CFG,
                                                  tol=tol)
    ref = truth(I, ts)
    for name, sol, info in (("JAX", jsol.displacements, jinfo),
                            ("port", tsol.displacements.numpy(), tinfo)):
        err = lane_err(sol, ref)
        cert = info["est"] <= tol
        bad = np.flatnonzero(cert & (err > tol))
        print(f"  {name}: {int(info['used_f64'].sum())} escalated, "
              f"{int(cert.sum())} certified, {len(bad)} certified lanes off "
              f"by more than tol")
        for k in bad:
            print(f"    lane {k}: est {info['est'][k]:.2e}, pivot "
                  f"{info['pivot'][k]:.2e}, error {err[k]:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--checked-lanes", type=int, default=2048)
    args = ap.parse_args(argv)
    # one thread: this build's threaded batched LU (the float64 truth at
    # 10x10) stalls in MKL's DLASWP
    torch.set_num_threads(1)
    accuracy(args.lanes)
    checked(args.checked_lanes)


if __name__ == "__main__":
    main()
