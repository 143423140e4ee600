"""Device resolution for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on; raises for an absent card.

    Entry points default to "cuda".  Without a usable card that request
    fails loudly: a silent CPU fallback would let a run that was meant to
    measure the card measure the host instead.
    A bare "cuda" resolves to the current card's index, so devices
    compare equal to those of the tensors made on them.

    Under a `FakeTensorMode` (the dry run, `launch/dryrun.py`) a "cuda"
    tensor holds no memory and launches nothing, so "cuda" resolves
    without a card (a bare "cuda" to index 0).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and _faking():
        return dev if dev.index is not None else torch.device("cuda", 0)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _faking() -> bool:
    """Whether a `FakeTensorMode` is active: tensors made now are fake."""
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


def device_scope(device):
    """A context that makes `device` the current card for the calls inside
    it (a no-op for the host): a serving thread pins its card with it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
