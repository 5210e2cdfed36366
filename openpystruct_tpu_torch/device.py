"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card
they raise instead of carrying on quietly on the CPU: the CPU runs only the
plain PyTorch versions of the kernels, and only when the caller asks for it
with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
