"""Device selection. The port runs on the card unless the caller asks for
the CPU: there is no silent fallback."""

from __future__ import annotations

from typing import Union

import torch


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
