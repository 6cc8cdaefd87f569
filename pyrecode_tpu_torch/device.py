"""The device a writer, reader or server runs its tensors on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for a user's choice; "cuda" without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
