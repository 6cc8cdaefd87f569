"""ReCoDeReader on PyTorch: bulk L1 decode through the unpack and decode kernels.

Subclass of :class:`pyrecode_tpu.reader.ReCoDeReader`; opening, seek tables,
random and sequential access, the sparse host decode and ``merge_parts``
are the JAX package's, which never import JAX.  Only ``read_frames_dense``
is overridden: host inflate as there, then for L1 the 12-bit unpack kernel
(other bit depths: plain unpack) and the decode kernel on the device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pyrecode_tpu.reader import ReCoDeReader as _JaxReCoDeReader
from pyrecode_tpu.reader import merge_parts  # noqa: F401  (re-exported)

from .device import resolve_device
from .ops.bitpack import bitunpack_values_device, packed_group_shape
from .ops.hopper_decode import decode_l1

# schemes whose decompress is stateless / thread-safe (as in the JAX reader)
_POOL_SAFE_SCHEMES = (0, 2, 3, 4, 5, 12)


class ReCoDeReader(_JaxReCoDeReader):
    """Decoder for merged (.rcX) and intermediate (.rcX_partNNN) files."""

    def __init__(self, file, is_intermediate: bool = False, device="cuda"):
        self._device = resolve_device(device)
        super().__init__(file, is_intermediate=is_intermediate)

    def read_frames_dense(self, start: int, count: int, use_tpu: bool = True,
                          verify: bool = False) -> np.ndarray:
        """Bulk-decode ``count`` frames starting at ``start`` to a dense array.

        ``use_tpu`` (the JAX reader's name) selects the device path; False
        decodes on the host as the JAX reader does.  Levels 2-4 decode on
        the host.  Scheme 12 on the device path is not ported yet.
        """
        level = int(self._header["reduction_level"])
        mode = int(self._header["rc_operation_mode"])
        scheme = int(self._header["compression_scheme"])
        if use_tpu and mode == 1 and scheme == 12:
            raise NotImplementedError(
                "scheme-12 device decode is not ported yet (ROADMAP Queue 1 item 7)")
        if not use_tpu or level != 1:
            return super().read_frames_dense(start, count, use_tpu=False, verify=verify)
        if self._is_intermediate:
            raise ValueError("Random access is not available for intermediate files")
        if not 0 <= start < int(self._header["nz"]):
            raise ValueError("Requested frame index is greater than number of frames in dataset")
        count = min(count, int(self._header["nz"]) - start)
        ny, nx = int(self._header["ny"]), int(self._header["nx"])
        bit_depth = int(self._header["target_bit_depth"])

        bitmaps, pixval_blobs = self._inflate(start, count, mode, scheme)
        _, g_bytes = packed_group_shape(bit_depth)
        max_bytes = max((len(b) for b in pixval_blobs), default=g_bytes)
        max_bytes = max(g_bytes, -(-max_bytes // g_bytes) * g_bytes)
        packed = np.zeros((count, max_bytes), dtype=np.uint8)
        for i, blob in enumerate(pixval_blobs):
            packed[i, : len(blob)] = np.frombuffer(blob, dtype=np.uint8)

        values = bitunpack_values_device(torch.from_numpy(packed).to(self._device), bit_depth)
        dense, overflow = decode_l1(torch.from_numpy(bitmaps).to(self._device), values, ny, nx)
        if bool(overflow.any()):
            raise ValueError("corrupt frame: more foreground pixels than stored values")
        return dense.cpu().numpy().astype(self._numpy_dtype, copy=False)

    def _inflate(self, start: int, count: int, mode: int, scheme: int):
        """Read and entropy-decode frames [start, start + count): bitmaps
        (count, bitmap bytes) uint8 and the pixel-value byte strings."""
        raw_blobs = []
        for z in range(start, start + count):
            self._fp.seek(self._frame_data_start_position + int(self._seek_table[z, 1]), 0)
            raw = self._read_raw_blobs(self._frame_metadata[z], read_data=True)
            raw_blobs.append((raw["binary_map"], raw.get("pixvals")))

        def inflate(blob_pair):
            bm, pv = blob_pair
            if mode == 0:
                return bm, pv
            return (self._codec.decompress(bm),
                    self._codec.decompress(pv) if pv is not None else None)

        if mode == 1 and count > 1 and scheme in _POOL_SAFE_SCHEMES:
            # the codecs release the GIL: fan the per-frame inflate over threads
            workers = min(count, max((os.cpu_count() or 2) // 2, 1))
            with ThreadPoolExecutor(max_workers=workers) as ex:
                inflated = list(ex.map(inflate, raw_blobs))
        else:
            inflated = [inflate(pair) for pair in raw_blobs]
        bitmaps = np.zeros((count, self._structures.binary_image_sz_bytes), dtype=np.uint8)
        for i, (bm, _) in enumerate(inflated):
            bitmaps[i] = np.frombuffer(bm, dtype=np.uint8)
        return bitmaps, [pv for _, pv in inflated]
