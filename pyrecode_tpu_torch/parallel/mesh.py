"""Device meshes for the codec, and placing batches on them.

Port of pyrecode_tpu/parallel/mesh.py.  A JAX ``Mesh`` becomes a small
explicit grid of ``torch.device``s with the same two axes:

* ``data`` -- frames, the primary scaling dimension (the reference's
  multi-process data parallelism, recode_writer.py:320-322);
* ``space`` -- frame rows, for frames too large to want one device's
  memory round trip per frame; 1 by default.

``NamedSharding``s become functions that place shards: :func:`shard_frames`
splits a frame batch contiguously over ``data`` (and rows over ``space``),
:func:`shard_batch` splits any batch over ``data``, and :func:`replicate`
copies a tensor once to every distinct device of the mesh.  A device may
appear several times in a mesh, the counterpart of XLA's virtual host
devices: shards on one device then run one after another on its current
stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class CodecMesh:
    """An (n_data, n_space) grid of devices; ``grid[d][s]`` is the device
    of data index d and space index s."""

    grid: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "space": len(self.grid[0])}

    @property
    def n_data(self) -> int:
        return len(self.grid)

    @property
    def n_space(self) -> int:
        return len(self.grid[0])

    @property
    def devices(self) -> List[torch.device]:
        """Every entry of the grid, row-major (repeats kept)."""
        return [dev for row in self.grid for dev in row]

    @property
    def data_devices(self) -> List[torch.device]:
        """The first device of each ``space`` group, in ``data`` order: where
        the frames of that data shard are reduced to one result."""
        return [row[0] for row in self.grid]


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_codec_mesh(n_data: Optional[int] = None, n_space: int = 1,
                    devices: Optional[Sequence] = None) -> CodecMesh:
    """Build a ('data', 'space') mesh.  ``devices`` defaults to every CUDA
    device; without CUDA and without ``devices`` it raises (there is no CPU
    fallback: pass ``[torch.device("cpu")] * n`` for a mesh of CPU twins)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_codec_mesh: no CUDA device (torch.cuda.is_available() is "
                               "False); pass devices= for a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_normalize(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data < 1 or n_space < 1 or n_data * n_space != len(devices):
        raise ValueError(f"mesh {n_data}x{n_space} does not match {len(devices)} devices")
    for dev in devices:
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
    grid = tuple(tuple(devices[d * n_space:(d + 1) * n_space]) for d in range(n_data))
    return CodecMesh(grid)


class Sharded:
    """A batch split along dim 0 over a mesh's ``data`` axis: shard d holds
    rows [d * B / n_data, (d + 1) * B / n_data) on ``mesh.data_devices[d]``.
    The counterpart of a JAX array sharded ``P('data', ...)``."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)

    def __iter__(self):
        return iter(self.shards)

    def to(self, device) -> torch.Tensor:
        """The whole batch as one tensor on ``device``."""
        return torch.cat([s.to(device) for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.to("cpu").numpy()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, Sharded):
        raise TypeError("already sharded")
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{n} {what} do not divide evenly over {parts} shards")
    return n // parts


def shard_batch(x, mesh: CodecMesh) -> Sharded:
    """Split a batch (numpy array or tensor, B along dim 0) contiguously
    over ``data``; a :class:`Sharded` batch of this mesh passes through."""
    if isinstance(x, Sharded):
        if len(x.shards) != mesh.n_data:
            raise ValueError(f"{len(x.shards)} shards for a mesh of {mesh.n_data} along data")
        return x
    t = _as_tensor(x)
    step = _split(t.shape[0], mesh.n_data, "frames")
    return Sharded([t[d * step:(d + 1) * step].contiguous().to(dev)
                    for d, dev in enumerate(mesh.data_devices)])


def shard_frames(frames, mesh: CodecMesh, shard_rows: bool = False) -> List[List[torch.Tensor]]:
    """Place a (B, H, W) frame batch: ``[d][s]`` is the (B / n_data, H /
    n_space, W) block of data index d and space index s on that device
    (``shard_rows``), or the whole (B / n_data, H, W) data shard on the
    first device of its space group (``[d][0]``, the only entry)."""
    t = _as_tensor(frames)
    if t.dim() != 3:
        raise ValueError(f"frames must be (B, H, W), got {tuple(t.shape)}")
    step = _split(t.shape[0], mesh.n_data, "frames")
    if not shard_rows:
        return [[t[d * step:(d + 1) * step].contiguous().to(row[0])]
                for d, row in enumerate(mesh.grid)]
    rows = _split(t.shape[1], mesh.n_space, "rows")
    return [[t[d * step:(d + 1) * step, s * rows:(s + 1) * rows].contiguous().to(dev)
             for s, dev in enumerate(row)] for d, row in enumerate(mesh.grid)]


def replicate(x, mesh: CodecMesh) -> dict:
    """One copy of ``x`` on every distinct device of the mesh, by device
    (the threshold is broadcast once); such copies pass through."""
    if isinstance(x, dict):
        return x
    t = _as_tensor(x)
    out = {}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = t.to(dev)
    return out
