"""A frozen plain reader of a merged ReCoDe container (version 0.2, mode 1).

Written from the container's layout alone; it imports nothing of the
program.  Layout:

* the 512-byte header (``HEADER_FIELDS``, little-endian integers);
* ``num_non_standard_frame_metadata`` descriptors of 100 bytes each, then
  ``source_header_length`` bytes of the source's own header;
* the per-frame metadata table: ``nz`` rows of u32 fields (L1/L2: the
  compressed bitmap's bytes, the compressed values' bytes, the packed
  values' bytes; L3/L4: the compressed bitmap's bytes), then the non-standard
  metadata bytes of each frame;
* the frame data, frame after frame: the compressed bitmap, then (L1/L2)
  the compressed values.

The bitmap is one bit a pixel, row-major, least significant bit first; L1's
values are the foreground's residuals in row-major order, ``target_bit_depth``
bits each, packed least significant bit first.  The entropy decoder of
scheme N is ``entropy/scheme<N>.py``'s ``decompress``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

UID = 158966344846346
HEADER_FIELDS = (
    ("uid", 8), ("version_major", 1), ("version_minor", 1), ("is_intermediate", 1),
    ("reduction_level", 1), ("rc_operation_mode", 1), ("is_bit_packed", 1),
    ("target_bit_depth", 1), ("nx", 4), ("ny", 4), ("nz", 4), ("frame_metadata_size", 1),
    ("num_non_standard_frame_metadata", 1), ("L2_statistics", 1), ("L4_centroiding", 1),
    ("compression_scheme", 1), ("compression_level", 1), ("source_file_type", 1),
    ("source_header_length", 2), ("source_header_position", 1), ("source_file_name", 100),
    ("calibration_file_name", 100), ("calibration_threshold_epsilon", 8),
    ("has_calibration_data", 1), ("frame_offset", 4), ("calibration_frame_offset", 4),
    ("num_calibration_frames", 4), ("source_bit_depth", 1), ("source_dtype", 1),
    ("target_dtype", 1), ("checksum", 32), ("futures", 219))
HEADER_BYTES = sum(size for _, size in HEADER_FIELDS)
TEXT_FIELDS = ("source_file_name", "calibration_file_name", "checksum", "futures")
ENTROPY = Path(__file__).resolve().parent / "entropy"


class ContainerError(ValueError):
    """The container does not hold what its layout says."""


def _decoder(scheme: int):
    path = ENTROPY / f"scheme{scheme}.py"
    if not path.exists():
        raise ContainerError(f"no plain entropy decoder for compression scheme {scheme}")
    spec = importlib.util.spec_from_file_location(f"portbench_entropy_scheme{scheme}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def decompress(blob: bytes) -> bytes:
        try:
            return module.decompress(blob)
        except Exception as exc:   # each codec raises its own kind of error
            raise ContainerError(f"scheme {scheme}: the stream does not decode: {exc}") from exc

    return decompress


class PlainContainer:
    """A merged container read in full into memory."""

    def __init__(self, path):
        raw = Path(path).read_bytes()
        if len(raw) < HEADER_BYTES:
            raise ContainerError("shorter than its header")
        self.header, pos = {}, 0
        for name, size in HEADER_FIELDS:
            if name not in TEXT_FIELDS:
                self.header[name] = int.from_bytes(raw[pos:pos + size], "little")
            pos += size
        h = self.header
        if h["uid"] != UID or (h["version_major"], h["version_minor"]) != (0, 2):
            raise ContainerError("not a version 0.2 ReCoDe container")
        if h["rc_operation_mode"] != 1:
            raise ContainerError("not a mode-1 container")
        self.level, self.bits = h["reduction_level"], h["target_bit_depth"]
        self.ny, self.nx, self.nz = h["ny"], h["nx"], h["nz"]
        self.decompress = _decoder(h["compression_scheme"])
        n_fields = 3 if self.level in (1, 2) else 1
        extra = 0
        for _ in range(h["num_non_standard_frame_metadata"]):
            extra += raw[pos + 99]
            pos += 100
        pos += h["source_header_length"]
        row = 4 * n_fields + extra
        table_end = pos + self.nz * row
        if table_end > len(raw):
            raise ContainerError("the metadata table runs past the end of the file")
        self.meta = [tuple(int.from_bytes(raw[p + 4 * k:p + 4 * k + 4], "little")
                           for k in range(n_fields))
                     for p in range(pos, table_end, row)]
        self.offsets, at = [], table_end
        for m in self.meta:
            self.offsets.append(at)
            at += m[0] + (m[1] if n_fields == 3 else 0)
        if at != len(raw):
            raise ContainerError(f"the seek table ends at {at}, the file at {len(raw)} bytes")
        self._raw = raw

    def frame(self, z: int):
        """(bitmap bits (ny*nx,) uint8 0/1, values int64 array or None)."""
        if not 0 <= z < self.nz:
            raise ContainerError(f"frame {z} of {self.nz}")
        m, at = self.meta[z], self.offsets[z]
        n = self.ny * self.nx
        bitmap = self.decompress(self._raw[at:at + m[0]])
        if len(bitmap) != (n + 7) // 8:
            raise ContainerError(f"frame {z}: a bitmap of {len(bitmap)} bytes")
        bits = np.unpackbits(np.frombuffer(bitmap, np.uint8), bitorder="little")[:n]
        if self.level == 2:
            raise ContainerError("the plain reader covers L1, L3 and L4")
        if self.level != 1:
            return bits, None
        packed = self.decompress(self._raw[at + m[0]:at + m[0] + m[1]])
        if len(packed) != m[2]:
            raise ContainerError(f"frame {z}: {len(packed)} value bytes, the table says {m[2]}")
        count = int(bits.sum())
        if len(packed) != (count * self.bits + 7) // 8:
            raise ContainerError(f"frame {z}: {len(packed)} value bytes for {count} values")
        return bits, unpack_values(packed, self.bits, count)

    def dense(self, z: int) -> np.ndarray:
        """Frame z as the reader gives it: L1 the residual at each foreground
        pixel, L3/L4 a 1 at each set bit; 0 elsewhere."""
        bits, values = self.frame(z)
        out = np.zeros(self.ny * self.nx, dtype=np.uint16)
        where = np.flatnonzero(bits)
        out[where] = values if self.level == 1 else 1
        return out.reshape(self.ny, self.nx)


def unpack_values(packed: bytes, bits: int, count: int) -> np.ndarray:
    """``count`` values of ``bits`` bits from an LSB-first bit stream."""
    stream = np.unpackbits(np.frombuffer(packed, np.uint8), bitorder="little")
    weights = np.left_shift(1, np.arange(bits, dtype=np.int64))
    return stream[:count * bits].reshape(count, bits).astype(np.int64) @ weights
