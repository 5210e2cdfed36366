"""The yardstick of the kernels' rooflines: operations and bytes a lane of
each datagen kernel needs, and the card's published peaks.

The counts are functions of the node count n, the refinement sweeps and the
kernel's mode alone, never of how a kernel is written, so a kernel's
roofline reads the same work whatever implements it.  They were counted
from the port's first fused kernels (``csrc/beam_opt.cu``,
``csrc/beam_opt_dd.cu``) and are frozen here.

Operations per node and lane, an FMA counting 2:

- the float32 opt step (#2, modes "semi" and "adjoint") and analysis (#1,
  "analysis"): the first forward sweep 108 (stiffness 10, assembly 30,
  scaling 14, scaled U 8, factor 32, forward substitution 14), the back
  sweep 14, each refinement a residual 134, a forward substitution 14 and
  a back sweep 16; the last semi back sweep's element work 72 (stiffness 9,
  forces 25, loss 16, gradient 7, Adam 15); in adjoint mode that sweep does
  110, then the adjoint solve's forward substitution 14, its back and
  refinement sweeps as the primal's, banded products 8 and Adam 15; the
  analysis adds the axial chain and pivot 20 to the first sweep, its back
  sweeps read C (8, 10 in a refinement) and its last one does stiffness 9,
  unscaling 4 and forces 25;
- the float64 opt step (#8, "opt_dd") and analysis (#7, "analysis_dd"):
  the forward sweep 129, the backward sweep 61, no refinement; the opt
  step adds loss 23 and Adam 15, all at the float64 rate.

Bytes: every input read once and every output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, without sparsity, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
F64_FLOPS_PER_S = 34e12        # float64 outside the tensor cores

#: the kernel each launch entry runs and the mode it runs in
KINDS = ("semi", "adjoint", "analysis", "opt_dd", "analysis_dd")


def flops_per_lane(n: int, refine: int, kind: str) -> int:
    if kind in ("analysis_dd", "opt_dd"):
        return (129 + 61 + (23 + 15 if kind == "opt_dd" else 0)) * n
    if kind in ("semi", "adjoint"):
        sweeps = 14 + refine * (134 + 14 + 16)
        if kind == "semi":
            return (108 + sweeps + 72) * n
        return (108 + sweeps + 110 + 14 + sweeps + 8 + 15) * n
    if kind == "analysis":
        return (108 + 20 + 8 + refine * (134 + 14 + 10) + 38) * n
    raise ValueError(f"unknown kernel kind {kind!r}")


def bytes_per_lane(n: int, kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    nelem = n - 1
    # I, Le, free (n, 3), loads (n), udl: float32 in every kernel
    inputs = 2 * nelem + 3 * n + n + 1
    if kind.startswith("analysis"):
        outputs = 3 * n + 2 * nelem + 1            # u, V, M, pivot
    else:
        inputs += 2 * nelem                        # mu, nu
        outputs = 3 * nelem + 4                    # I, mu, nu, stats
        outputs += kind == "opt_dd"                # pivot
    return 4 * (inputs + outputs)


def peak_flops(kind: str) -> float:
    return F64_FLOPS_PER_S if kind.endswith("_dd") else F32_FLOPS_PER_S


def bound_s(lanes: int, n: int, refine: int, kind: str) -> float:
    """The least time the card could take for one launch over ``lanes``:
    the larger of its bytes over the bandwidth and its operations over the
    peak rate."""
    t_bytes = lanes * bytes_per_lane(n, kind) / HBM_BYTES_PER_S
    t_ops = lanes * flops_per_lane(n, refine, kind) / peak_flops(kind)
    return max(t_bytes, t_ops)


def kernel_roofline(r, kinds, names):
    """A kernel's share of its roofline, in %, over a traced window: the
    summed ``bound_s`` of its launches of ``kinds`` (``r.launches``) over
    the summed device time of the profiler's operations whose name holds
    one of ``names``; None where either is missing."""
    if r.profile is None:
        return None
    least = sum(count * bound_s(lanes, n, refine, kind)
                for (kind, lanes, n, refine), count in r.launches.items()
                if kind in kinds)
    spent = sum(secs for name, (secs, _) in r.profile["device_ops"].items()
                if any(k in name for k in names))
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
