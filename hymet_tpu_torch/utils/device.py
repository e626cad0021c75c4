"""Device selection. The port runs on the card unless the caller asks for
the CPU: there is no silent fallback."""

from __future__ import annotations

import os
from typing import Union

import torch

# HYMET_PLATFORM, the variable the JAX command line reads, -> torch device
PLATFORMS = {"": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and no
    card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path"
        )
    return dev


def device_from_env() -> str:
    """The torch device ``HYMET_PLATFORM`` names: unset, ``gpu`` or ``cuda``
    the card (resolving it fails without one), ``cpu`` the plain CPU path;
    anything else is an error."""
    platform = os.environ.get("HYMET_PLATFORM", "")
    if platform not in PLATFORMS:
        raise ValueError(f"HYMET_PLATFORM={platform!r}: use gpu, cuda or cpu")
    return PLATFORMS[platform]
