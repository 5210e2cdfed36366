"""Checkpointing of nested dicts of tensors (port of ``train/checkpoint.py``).

The reference only ``torch.save``'s a best model state_dict
(OpenPyStruct_FNN_MultiCase.py:577-580).  Here a nested dict of tensors
(``FitResult.params``: ``{"model": state_dict, "alpha": tensor}``) is
written with ``torch.save`` to a temporary file beside ``path`` and renamed
over it, so a reader never sees a partial file.  ``fit(checkpoint_dir=)``
writes its whole training state through it and ``fit(resume_from=)`` reads
it back (``train/harness.py``); orbax files of the JAX package are not
read.
"""

from __future__ import annotations

import os

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str, tree) -> None:
    """Save a nested dict of tensors to the file ``path``, atomically."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(_to_cpu(tree), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, device=None):
    """Load a checkpoint written by ``save_checkpoint``; tensors land on
    ``device`` (default: the CPU).  Only tensors and plain containers are
    unpickled (``weights_only``)."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)
