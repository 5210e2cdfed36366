"""State carried between the JAX package and the port as numpy arrays.

What crosses over is scenarios, optimizer state and the TFD surrogate's
weights.  The tests draw scenarios with the JAX sampler and initialize
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


def _torch_module(flax_name: str) -> str:
    for flax_prefix, name in _FLAX_MODULES:
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
    device = resolve_device(device)
    if "model" in params:
        return {"model": tfd_params_from_flax(params["model"], device),
                "alpha": torch.as_tensor(np.asarray(params["alpha"]),
                                         device=device)}
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
        name = ".".join([_torch_module(m) for m in mods] + [leaf])
        out[name] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def tfd_params_to_flax(state: dict, num_heads: int) -> dict:
    """The inverse of ``tfd_params_from_flax``: a ``state_dict`` (or a
    ``{"model": ..., "alpha": ...}`` dict) -> the flax params tree as numpy
    arrays; ``num_heads`` unfolds the attention's head axes."""
    if "model" in state:
        return {"model": tfd_params_to_flax(state["model"], num_heads),
                "alpha": state["alpha"].detach().cpu().numpy()}
    tree = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        *mods, leaf = name.replace("layers.", "layers_").split(".")
        path = []
        for m in mods:
            for flax_prefix, port in _FLAX_MODULES:
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
