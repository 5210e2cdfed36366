"""State carried between the JAX package and the port as numpy arrays.

What crosses over is scenarios, optimizer state and the surrogates'
weights (all seven families; the PINN's and the FNO's with their BatchNorm
statistics).  The tests draw scenarios with the JAX sampler and initialize
weights with flax (torch draws cannot match ``jax.random``), pass them
through here, and hold the port's results against the JAX package's on the
same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from openpystruct_tpu_torch.device import resolve_device
from openpystruct_tpu_torch.fem.beam import BeamScenario

_SCENARIO_FIELDS = ("node_x", "roller_mask", "point_loads", "udl",
                    "roller_order", "force_order")


def scenario_from_numpy(arrays: dict, device="cuda",
                        dtype=torch.float32) -> BeamScenario:
    """``{"node_x", "roller_mask", "point_loads", "udl"[, "roller_order",
    "force_order"]}`` numpy arrays -> BeamScenario on ``device``; floating
    fields are cast to ``dtype``."""
    device = resolve_device(device)

    def put(x):
        if x is None:
            return None
        t = torch.from_numpy(np.array(x))
        return (t.to(dtype) if t.is_floating_point() else t).to(device)

    return BeamScenario(**{k: put(arrays.get(k)) for k in _SCENARIO_FIELDS})


def scenario_to_numpy(scenario: BeamScenario) -> dict:
    return {k: getattr(scenario, k).detach().cpu().numpy()
            for k in _SCENARIO_FIELDS if getattr(scenario, k) is not None}


def opt_state_from_numpy(I, mu, nu, device="cuda", dtype=torch.float32):
    """Optimizer state (I, mu, nu), each (B, nelem), as tensors."""
    device = resolve_device(device)
    return tuple(torch.from_numpy(np.array(x)).to(dtype).to(device)
                 for x in (I, mu, nu))


def opt_state_to_numpy(I, mu, nu):
    return tuple(x.detach().cpu().numpy() for x in (I, mu, nu))


# flax module names in the TFD's params tree -> the port's submodule names
# (models/transformer_diffusion.py); an index suffix "_k" is kept where the
# port keeps it
_FLAX_MODULES = (("DiffusionModule_", "diffusion"),
                 ("TransformerEncoderLayer_", "layers."),
                 ("MultiHeadDotProductAttention_", "attn"),
                 ("Dense_", "dense_"), ("LayerNorm_", "norm_"))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# the Bayesian TFDs' tree (models/bayesian.py): the TFD's trunk, the
# Bayesian diffusion module and output head; BayesLinear leaves keep
# flax's names and layout
_BNN_MODULES = (("BayesianDiffusionModule_", "diffusion"),
                ("BayesianDiffusionMLP_", "mlp"),
                ("BayesianOutputMLP_", "head"),
                ("BayesLinear_", "bayes_")) + _FLAX_MODULES


def _torch_module(flax_name: str, modules=_FLAX_MODULES) -> str:
    for flax_prefix, name in modules:
        if flax_name.startswith(flax_prefix):
            idx = flax_name[len(flax_prefix):]
            return name + idx if name.endswith(("_", ".")) else name
    return flax_name   # query, key, value, out


def tfd_params_from_flax(params: dict, device="cuda") -> dict:
    """The flax params tree of ``TransformerDiffusionModel`` (numpy arrays)
    -> the port's ``state_dict``; a ``{"model": ..., "alpha": ...}`` tree
    (the JAX harness's params) -> ``{"model": state_dict, "alpha": tensor}``.

    Dense kernels (in, out) become (out, in) weights; the attention's
    query/key/value kernels (d, heads, head_dim) become (heads * head_dim,
    d), their biases (heads, head_dim) flat, the out kernel (heads,
    head_dim, d) becomes (d, heads * head_dim); LayerNorm scale/bias become
    weight/bias."""
    return _tfd_from_flax(params, device, _FLAX_MODULES)


def tfd_params_to_flax(state: dict, num_heads: int) -> dict:
    """The inverse of ``tfd_params_from_flax``: a ``state_dict`` (or a
    ``{"model": ..., "alpha": ...}`` dict) -> the flax params tree as numpy
    arrays; ``num_heads`` unfolds the attention's head axes."""
    return _tfd_to_flax(state, num_heads, _FLAX_MODULES)


def bnn_params_from_flax(params: dict, device="cuda") -> dict:
    """The flax params tree of ``BayesianTransformerDiffusionModel`` ->
    the port's ``state_dict`` (or ``{"model": ..., "alpha": ...}``): the
    trunk as ``tfd_params_from_flax`` carries it, the ``BayesLinear``
    parameters, the class token and the output scales as they are."""
    return _tfd_from_flax(params, device, _BNN_MODULES)


def bnn_params_to_flax(state: dict, num_heads: int = 24) -> dict:
    """The inverse of ``bnn_params_from_flax``."""
    return _tfd_to_flax(state, num_heads, _BNN_MODULES)


def _alpha(params, device):
    return torch.as_tensor(np.asarray(params["alpha"]),
                           device=resolve_device(device))


def _tfd_from_flax(params: dict, device, modules) -> dict:
    device = resolve_device(device)
    if "model" in params:
        return {"model": _tfd_from_flax(params["model"], device, modules),
                "alpha": _alpha(params, device)}
    out = {}
    for path, a in _flatten(params):
        a = np.asarray(a)
        *mods, leaf = path
        if leaf == "kernel":
            if a.ndim == 3:   # attention: fold the (heads, head_dim) axes
                a = (a.reshape(-1, a.shape[-1]) if mods[-1] == "out"
                     else a.reshape(a.shape[0], -1))
            a, leaf = a.T, "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf == "bias":
            a = a.reshape(-1)
        name = ".".join([_torch_module(m, modules) for m in mods] + [leaf])
        out[name] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def _tfd_to_flax(state: dict, num_heads: int, modules) -> dict:
    if "model" in state:
        return {"model": _tfd_to_flax(state["model"], num_heads, modules),
                "alpha": state["alpha"].detach().cpu().numpy()}
    tree = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        *mods, leaf = name.replace("layers.", "layers_").split(".")
        path = []
        for m in mods:
            for flax_prefix, port in modules:
                port = port.replace(".", "_")
                if m == port or (port.endswith("_") and m.startswith(port)):
                    m = flax_prefix + (m[len(port):] or "0")
                    break
            path.append(m)
        attn = len(path) > 1 and path[-2].startswith(
            "MultiHeadDotProductAttention_")
        if leaf == "weight" and path and path[-1].startswith("LayerNorm_"):
            leaf = "scale"
        elif leaf == "weight":
            a, leaf = a.T, "kernel"
            if attn and path[-1] == "out":
                a = a.reshape(num_heads, -1, a.shape[-1])
            elif attn:
                a = a.reshape(a.shape[0], num_heads, -1)
        elif leaf == "bias" and attn and path[-1] != "out":
            a = a.reshape(num_heads, -1)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


# flax module names in the FNN's and the PINN's trees -> the port's
# (models/fnn.py, models/pinn.py), the GNN's (models/gnn.py) and the FNO's
# (models/fno.py); a port name without an index suffix names the module's
# only child of that kind
_MLP_MODULES = (("Dense_", "dense_"), ("LayerNorm_", "norm_"),
                ("BatchNorm_", "norm_"), ("PINNResidualBlock_", "blocks."),
                ("ResidualBlock_", "blocks."), ("FNOBlock1d_", "blocks."),
                ("Conv_", "conv"), ("SpectralConv1d_", "spectral"))
_SINGLE = {"conv": "Conv_0", "spectral": "SpectralConv1d_0"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _mlp_name(mods) -> str:
    out = []
    for m in mods:
        for flax_prefix, port in _MLP_MODULES:
            if m.startswith(flax_prefix):
                out.append(port if port in _SINGLE
                           else port + m[len(flax_prefix):])
                break
        else:
            raise ValueError(f"unknown flax module {m!r}")
    return ".".join(out)


def _mlp_from_flax(params: dict, batch_stats, device) -> dict:
    """Dense kernels (in, out) -> (out, in) weights; the conv kernel (k,
    in, out) -> (out, in, k); norm scales -> weights; batch_stats mean /
    var -> running_mean / running_var buffers."""
    device = resolve_device(device)
    out = {}
    for path, a in _flatten(params):
        a = np.asarray(a)
        *mods, leaf = path
        if leaf == "kernel":
            a, leaf = (a.T if a.ndim == 2 else a.transpose(2, 1, 0)), "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[f"{_mlp_name(mods)}.{leaf}"] = torch.tensor(
            np.ascontiguousarray(a), device=device)
    for path, a in _flatten(batch_stats or {}):
        *mods, leaf = path
        out[f"{_mlp_name(mods)}.{_STATS[leaf]}"] = torch.tensor(
            np.ascontiguousarray(np.asarray(a)), device=device)
    return out


def _mlp_to_flax(state: dict, block: str):
    """The inverse of ``_mlp_from_flax``: (params, batch_stats) trees of
    numpy arrays; ``block`` is the flax name of the residual block."""
    bn = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    params, stats = {}, {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        *mods, leaf = name.split(".")
        path, prefix, i = [], [], 0
        while i < len(mods):
            m = mods[i]
            if m == "blocks":
                path.append(f"{block}_{mods[i + 1]}")
                prefix += mods[i:i + 2]
                i += 2
                continue
            prefix.append(m)
            if m in _SINGLE:
                path.append(_SINGLE[m])
            elif m.startswith("dense_"):
                path.append("Dense_" + m[len("dense_"):])
            else:
                kind = ("BatchNorm_" if ".".join(prefix) in bn
                        else "LayerNorm_")
                path.append(kind + m[len("norm_"):])
            i += 1
        if leaf in ("running_mean", "running_var"):
            node, leaf = stats, leaf[len("running_"):]
        else:
            node = params
            if leaf == "weight" and path[-1].startswith(("LayerNorm_",
                                                          "BatchNorm_")):
                leaf = "scale"
            elif leaf == "weight":
                a, leaf = (a.T if a.ndim == 2
                           else a.transpose(2, 1, 0)), "kernel"
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return params, stats


def fnn_params_from_flax(params: dict, device="cuda") -> dict:
    """The flax params tree of ``FNNWithResidual`` (numpy arrays) -> the
    port's ``state_dict``; a ``{"model": ..., "alpha": ...}`` tree -> ``{"model":
    state_dict, "alpha": tensor}``."""
    if "model" in params:
        return {"model": fnn_params_from_flax(params["model"], device),
                "alpha": _alpha(params, device)}
    return _mlp_from_flax(params, None, device)


def fnn_params_to_flax(state: dict) -> dict:
    """The inverse of ``fnn_params_from_flax``."""
    if "model" in state:
        return {"model": fnn_params_to_flax(state["model"]),
                "alpha": state["alpha"].detach().cpu().numpy()}
    return _mlp_to_flax(state, "ResidualBlock")[0]


def pinn_params_from_flax(params: dict, batch_stats: dict,
                          device="cuda") -> dict:
    """The flax params and batch_stats trees of ``PINNWithResidual`` (numpy
    arrays) -> the port's ``state_dict``, the running statistics as
    buffers; a ``{"model": ..., "alpha": ...}`` params tree -> ``{"model":
    state_dict, "alpha": tensor}`` (``FitResult.params``'s layout)."""
    if "model" in params:
        return {"model": pinn_params_from_flax(params["model"], batch_stats,
                                               device),
                "alpha": _alpha(params, device)}
    return _mlp_from_flax(params, batch_stats, device)


def pinn_params_to_flax(state: dict):
    """The inverse of ``pinn_params_from_flax``: (params, batch_stats); a
    ``{"model": ..., "alpha": ...}`` dict gives the params as ``{"model":
    ..., "alpha": ...}``."""
    if "model" in state:
        params, stats = pinn_params_to_flax(state["model"])
        return ({"model": params,
                 "alpha": state["alpha"].detach().cpu().numpy()}, stats)
    return _mlp_to_flax(state, "PINNResidualBlock")


def gnn_params_from_flax(params: dict, device="cuda") -> dict:
    """The flax params tree of ``ChainGNN`` -> the port's ``state_dict``
    (or ``{"model": ..., "alpha": ...}``)."""
    if "model" in params:
        return {"model": gnn_params_from_flax(params["model"], device),
                "alpha": _alpha(params, device)}
    return _mlp_from_flax(params, None, device)


def gnn_params_to_flax(state: dict) -> dict:
    """The inverse of ``gnn_params_from_flax``."""
    if "model" in state:
        return {"model": gnn_params_to_flax(state["model"]),
                "alpha": state["alpha"].detach().cpu().numpy()}
    return _mlp_to_flax(state, None)[0]


def fno_params_from_flax(params: dict, batch_stats: dict,
                         device="cuda") -> dict:
    """The flax params and batch_stats trees of ``FNO1dModel`` -> the
    port's ``state_dict``, the running statistics as buffers; the spectral
    weights (in, out, modes) as they are.  A ``{"model": ..., "alpha":
    ...}`` params tree gives ``{"model": state_dict, "alpha": tensor}``."""
    if "model" in params:
        return {"model": fno_params_from_flax(params["model"], batch_stats,
                                              device),
                "alpha": _alpha(params, device)}
    return _mlp_from_flax(params, batch_stats, device)


def fno_params_to_flax(state: dict):
    """The inverse of ``fno_params_from_flax``: (params, batch_stats)."""
    if "model" in state:
        params, stats = fno_params_to_flax(state["model"])
        return ({"model": params,
                 "alpha": state["alpha"].detach().cpu().numpy()}, stats)
    return _mlp_to_flax(state, "FNOBlock1d")
