"""Per-frame metadata schema for the ReCoDe container.

The port's own copy of pyrecode_tpu/structures.py: the port imports nothing of the
JAX package.

Capability parity with the reference ``ReCoDeStructures`` (structures.py:5-102):
for each (reduction_level, rc_operation_mode) pair, the schema lists the u32
little-endian length fields stored per frame, and a calculator derives each
frame's on-disk data size from its metadata — this is what seek tables are
built from.

Frame record layouts (the de-facto wire format, reference
recode_writer.py:482-550; the leading u32 frame_id exists only in
*intermediate* part files and is dropped into the metadata table on merge):

    L1 mode 0: [frame_id u32][bytes_in_packed_pixvals u32][bitmap][packed pixvals]
    L1 mode 1: [frame_id u32][len_cbm u32][len_cpx u32][len_packed u32][cbm][cpx]
    L2 mode 0: [frame_id u32][bytes_in_packed_summary_stats u32][bitmap][packed stats]
    L2 mode 1: [frame_id u32][len_cbm u32][len_css u32][len_packed u32][cbm][css]
    L3/L4 mode 0: [frame_id u32][bitmap]
    L3/L4 mode 1: [frame_id u32][len_cbm u32][cbm]

where bitmap = ceil(nx*ny/8) bytes of the bit-packed binary map, cbm/cpx/css
are entropy-compressed blobs and "len_packed" records the *uncompressed*
packed-pixval byte count (not part of the frame size).  :func:`frame_record`
builds every one of them from the schema; the writer builds none by hand.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

# schema: (reduction_level, rc_operation_mode) -> list of metadata field specs
_METADATA_FIELD = lambda name, counts: {  # noqa: E731 - tiny local factory
    "name": name,
    "bytes": 4,
    "dtype": np.uint32,
    "is_frame_size": counts,
}


def _build_schema() -> Dict[Tuple[int, int], List[dict]]:
    schema: Dict[Tuple[int, int], List[dict]] = {}
    schema[(1, 0)] = [_METADATA_FIELD("bytes_in_packed_pixvals", True)]
    schema[(1, 1)] = [
        _METADATA_FIELD("bytes_in_compressed_binary_map", True),
        _METADATA_FIELD("bytes_in_compressed_pixvals", True),
        _METADATA_FIELD("bytes_in_packed_pixvals", False),
    ]
    schema[(2, 0)] = [_METADATA_FIELD("bytes_in_packed_summary_stats", True)]
    schema[(2, 1)] = [
        _METADATA_FIELD("bytes_in_compressed_binary_map", True),
        _METADATA_FIELD("bytes_in_compressed_summary_stats", True),
        _METADATA_FIELD("bytes_in_packed_summary_stats", False),
    ]
    for level in (3, 4):
        schema[(level, 0)] = []
        schema[(level, 1)] = [_METADATA_FIELD("bytes_in_compressed_binary_map", True)]
    return schema


_SCHEMA = _build_schema()


def frame_record(reduction_level: int, rc_operation_mode: int, frame_id: int, first: bytes,
                 second: Optional[bytes] = None, uncompressed_length: int = 0) -> bytes:
    """One intermediate-file frame record: the u32 ``frame_id``, the
    (level, mode) pair's metadata fields, then ``first`` (the bitmap, raw in
    mode 0, coded in mode 1) and ``second`` (the packed values or summary
    statistics of L1/L2, raw or coded; None at L3/L4).  A field that counts
    towards the frame size holds its stream's length; the one that does not
    (mode 1's ``bytes_in_packed_*``) holds ``uncompressed_length``, the
    packed stream's length before coding."""
    fields = []
    for field in _SCHEMA[(reduction_level, rc_operation_mode)]:
        if not field["is_frame_size"]:
            value = uncompressed_length
        elif field["name"] == "bytes_in_compressed_binary_map":
            value = len(first)
        else:
            value = len(second)
        fields.append(int(value).to_bytes(field["bytes"], "little"))
    return b"".join([int(frame_id).to_bytes(4, "little"), *fields, first, second or b""])


class ReCoDeStructures:
    """Schema of per-frame standard metadata + frame-size calculator."""

    def __init__(self, recode_header: dict):
        self._recode_header = recode_header
        self._binary_image_sz_bytes = int(
            math.ceil(float(recode_header["nx"]) * float(recode_header["ny"]) / 8.0)
        )

    @property
    def binary_image_sz_bytes(self) -> int:
        return self._binary_image_sz_bytes

    @property
    def standard_frame_metadata_structure(self) -> Dict[Tuple[int, int], List[dict]]:
        return _SCHEMA

    def standard_frame_metadata_structure_for(self, reduction_level: int, rc_operation_mode: int) -> List[dict]:
        return _SCHEMA[(reduction_level, rc_operation_mode)]

    def get_standard_frame_metadata_size(self, reduction_level: int, rc_operation_mode: int) -> int:
        """Total bytes of standard per-frame metadata for this configuration."""
        return sum(f["bytes"] for f in _SCHEMA[(reduction_level, rc_operation_mode)])

    def get_frame_data_size(self, reduction_level: int, rc_operation_mode: int, metadata: dict) -> int:
        """On-disk size of one frame's data (excluding its metadata fields)."""
        bitmap = self._binary_image_sz_bytes
        if reduction_level == 1:
            if rc_operation_mode == 0:
                return bitmap + int(metadata["bytes_in_packed_pixvals"])
            return int(metadata["bytes_in_compressed_binary_map"]) + int(metadata["bytes_in_compressed_pixvals"])
        if reduction_level == 2:
            if rc_operation_mode == 0:
                return bitmap + int(metadata["bytes_in_packed_summary_stats"])
            return int(metadata["bytes_in_compressed_binary_map"]) + int(
                metadata["bytes_in_compressed_summary_stats"]
            )
        if reduction_level in (3, 4):
            if rc_operation_mode == 0:
                return bitmap
            return int(metadata["bytes_in_compressed_binary_map"])
        raise ValueError(f"Unknown reduction level: {reduction_level}")
