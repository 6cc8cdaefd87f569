"""What every kernel wrapper shares: argument checks, launch counts, errors.

A wrapper runs its kernel's plain PyTorch twin only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises.  It launches on
PyTorch's current stream of the tensors' device and does not synchronise.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build


class LaunchCounter:
    """Number of kernel launches; wrappers run from several threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


def on_host(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if all lie on one CUDA
    device; raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return False


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(counter: LaunchCounter, fn_name: str, device: torch.device, *args) -> None:
    """Call the library's entry point ``fn_name`` on ``device``'s current
    stream (appended as the last argument), count it, and raise on a CUDA
    error from the launch."""
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    counter.add()
    if device.index is None or device.index == torch.cuda.current_device():
        rc = getattr(lib, fn_name)(*args, stream)
    else:   # the launch goes to the calling thread's current device
        with torch.cuda.device(device):
            rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name}: CUDA error {rc} ({lib.pr_error_string(rc).decode()})")


def u16_to_i32(t: torch.Tensor) -> torch.Tensor:
    """uint16 -> int32 by value, through int16 (PyTorch implements few
    uint16 operations on CUDA)."""
    return t.view(torch.int16).to(torch.int32) & 0xFFFF


def i32_to_u16(t: torch.Tensor) -> torch.Tensor:
    """int32 -> uint16 modulo 2**16, through int16."""
    low = t & 0xFFFF
    return torch.where(low >= 0x8000, low - 0x10000, low).to(torch.int16).view(torch.uint16)


def num_tiles(n_pixels: int) -> int:
    """Tiles of the encode/decode kernels' scan for one frame of n_pixels."""
    return int(_build.load().pr_num_tiles(n_pixels))


# pixels of one tile of the encode/decode kernels (csrc/common.cuh: 8 warps
# of 16 words of 32 pixels), for the twins of their per-tile outputs
TILE_PIXELS = 4096


def tile_sums(values: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(B, n) -> (B, n_tiles) sums over consecutive TILE_PIXELS, the last
    tile zero-padded."""
    B, n = values.shape
    padded = torch.nn.functional.pad(values, (0, n_tiles * TILE_PIXELS - n))
    return padded.reshape(B, n_tiles, TILE_PIXELS).sum(dim=2)


def deflate_tiles(n: int) -> int:
    """Tiles of the tokenize / assemble kernels for a row of n bytes or tokens."""
    return int(_build.load().pr_deflate_tiles(n))
