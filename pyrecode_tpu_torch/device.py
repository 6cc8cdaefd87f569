"""The device a writer, reader or server runs its tensors on, and the pinned
host memory their copies to and from the card go through."""

from __future__ import annotations

from typing import Optional

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


def pinned_empty(shape, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A tensor of page-locked host memory from PyTorch's caching host
    allocator, or None where pinning is refused (then copy through pageable
    memory).  Nothing in the port empties that cache: a freed block stays
    pinned for the process's next writer buffer or reader output."""
    try:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    except RuntimeError:
        return None
