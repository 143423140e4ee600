"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on; raises for an absent card.

    Entry points default to "cuda".  Without a usable card that request
    fails loudly: a silent CPU fallback would let a run that was meant to
    measure the card measure the host instead.
    A bare "cuda" resolves to the current card's index, so devices
    compare equal to those of the tensors made on them.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
