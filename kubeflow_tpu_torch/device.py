"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument. ``None`` means the CUDA
card; the CPU is used only when the caller asks for it by name. With no
card and no ``device="cpu"`` the entry point raises — nothing drops to
the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else is
    taken as named. A CUDA device asked for by name also needs a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asked for a CUDA device, but none "
                "is available; pass device='cpu' to run on the CPU"
            )
        # Indexed, so two spellings of one card compare equal.
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
