"""ReCoDe container header codec (versions 0.1 and 0.2).

The port's own copy of pyrecode_tpu/header.py: the port imports nothing of the
JAX package.

Byte-compatible with the reference container format:

* v0.1 = 321-byte header, 27 fields (reference recode_header.py:27-56)
* v0.2 = 512-byte header, 31 fields, adding ``is_intermediate``,
  ``is_bit_packed``, ``frame_metadata_size`` and
  ``num_non_standard_frame_metadata`` (reference recode_header.py:58-94)

All integer fields are little-endian.  String fields (``source_file_name``,
``calibration_file_name``) are 100 bytes, space-padded UTF-8.  ``checksum`` and
``futures`` are raw byte blobs.  On load, the version is sniffed from the
first three fields (uid, version_major, version_minor) and the appropriate
layout is selected (reference recode_header.py:188-249).  After the v0.2
header come ``num_non_standard_frame_metadata`` 100-byte descriptors (99-byte
name + 1-byte size) and then ``source_header_length`` bytes of the source
file's own header.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import BinaryIO, Dict, Optional

import numpy as np

RECODE_UID = 158966344846346


@dataclass(frozen=True)
class _Field:
    name: str
    nbytes: int
    kind: str  # "int" | "str" | "bytes"


def _int_field(name: str, nbytes: int) -> _Field:
    return _Field(name, nbytes, "int")


_FIELDS_V01 = (
    _int_field("uid", 8),
    _int_field("version_major", 1),
    _int_field("version_minor", 1),
    _int_field("reduction_level", 1),
    _int_field("rc_operation_mode", 1),
    _int_field("target_bit_depth", 1),
    _int_field("nx", 2),
    _int_field("ny", 2),
    _int_field("nz", 4),
    _int_field("L2_statistics", 1),
    _int_field("L4_centroiding", 1),
    _int_field("compression_scheme", 1),
    _int_field("compression_level", 1),
    _int_field("source_file_type", 1),
    _int_field("source_header_length", 2),
    _int_field("source_header_position", 1),
    _Field("source_file_name", 100, "str"),
    _Field("calibration_file_name", 100, "str"),
    _int_field("calibration_threshold_epsilon", 2),
    _int_field("has_calibration_data", 1),
    _int_field("frame_offset", 4),
    _int_field("calibration_frame_offset", 4),
    _int_field("num_calibration_frames", 4),
    _int_field("source_bit_depth", 1),
    _int_field("source_dtype", 1),
    _int_field("target_dtype", 1),
    _Field("checksum", 32, "bytes"),
    _Field("futures", 42, "bytes"),
)

_FIELDS_V02 = (
    _int_field("uid", 8),
    _int_field("version_major", 1),
    _int_field("version_minor", 1),
    _int_field("is_intermediate", 1),
    _int_field("reduction_level", 1),
    _int_field("rc_operation_mode", 1),
    _int_field("is_bit_packed", 1),
    _int_field("target_bit_depth", 1),
    _int_field("nx", 4),
    _int_field("ny", 4),
    _int_field("nz", 4),
    _int_field("frame_metadata_size", 1),
    _int_field("num_non_standard_frame_metadata", 1),
    _int_field("L2_statistics", 1),
    _int_field("L4_centroiding", 1),
    _int_field("compression_scheme", 1),
    _int_field("compression_level", 1),
    _int_field("source_file_type", 1),
    _int_field("source_header_length", 2),
    _int_field("source_header_position", 1),
    _Field("source_file_name", 100, "str"),
    _Field("calibration_file_name", 100, "str"),
    _int_field("calibration_threshold_epsilon", 8),
    _int_field("has_calibration_data", 1),
    _int_field("frame_offset", 4),
    _int_field("calibration_frame_offset", 4),
    _int_field("num_calibration_frames", 4),
    _int_field("source_bit_depth", 1),
    _int_field("source_dtype", 1),
    _int_field("target_dtype", 1),
    _Field("checksum", 32, "bytes"),
    _Field("futures", 219, "bytes"),
)


def _fields_for_version(version: float):
    return _FIELDS_V01 if version < 0.2 else _FIELDS_V02


class ReCoDeHeader:
    """Create, load, serialize and patch ReCoDe file headers.

    API parity with the reference ``ReCoDeHeader`` (recode_header.py:6-349):
    ``create``, ``load``, ``serialize``, ``serialize_to``, ``as_dict``,
    ``get``/``set``/``update``, ``get_frame_data_offset``,
    ``get_field_position_in_bytes``, ``get_definition``, ``validate``,
    ``print``, plus the ``source_header`` / ``non_standard_metadata_sizes``
    properties.
    """

    def __init__(self, version: float = 0.2):
        self._version = version
        self._values: Dict[str, object] = {}
        self._source_header: Optional[bytes] = None
        self._non_standard_frame_metadata_sizes: Dict[str, int] = {}

    # ------------------------------------------------------------------ layout

    @property
    def version(self) -> float:
        return self._version

    @property
    def fields(self):
        return _fields_for_version(self._version)

    @property
    def recode_header_length(self) -> int:
        return sum(f.nbytes for f in self.fields)

    def get_definition(self, name: str) -> dict:
        for f in self.fields:
            if f.name == name:
                return {"name": f.name, "bytes": f.nbytes, "kind": f.kind}
        raise ValueError("The requested field does not exist in recode header")

    def get_field_position_in_bytes(self, name: str) -> int:
        position = 0
        for f in self.fields:
            if f.name == name:
                return position
            position += f.nbytes
        raise ValueError("The requested field is not defined in the header")

    # ------------------------------------------------------------------ values

    def as_dict(self) -> Dict[str, object]:
        return self._values

    def get(self, field_name: str):
        if field_name not in self._values:
            raise ValueError("The requested field does not exist in recode header")
        return self._values[field_name]

    def set(self, field_name: str, value):
        if field_name not in self._values:
            raise ValueError("The requested field does not exist in recode header")
        self._values[field_name] = value

    # the reference exposes both set() (checked) and update() (unchecked)
    def update(self, name: str, value):
        self._values[name] = value

    # ------------------------------------------------------------------ create

    def create(self, init_params, input_params, is_intermediate: bool) -> None:
        """Populate header fields from session + codec params.

        Mirrors reference recode_header.py:96-163 (v0.2 branch at :127-163).
        """
        h = self._values
        h["uid"] = RECODE_UID
        h["version_major"] = 0
        if self._version < 0.2:
            h["version_minor"] = 1
        else:
            h["version_minor"] = 2
            h["is_intermediate"] = int(bool(is_intermediate))
            h["is_bit_packed"] = 1
            h["frame_metadata_size"] = 0
            h["num_non_standard_frame_metadata"] = 0
        h["reduction_level"] = input_params.reduction_level
        h["rc_operation_mode"] = input_params.rc_operation_mode
        h["target_bit_depth"] = input_params.target_bit_depth
        h["nx"] = input_params.nx
        h["ny"] = input_params.ny
        h["nz"] = input_params.nz
        h["L2_statistics"] = input_params.L2_statistics
        h["L4_centroiding"] = input_params.L4_centroiding
        h["compression_scheme"] = input_params.compression_scheme
        h["compression_level"] = input_params.compression_level
        h["source_file_type"] = input_params.source_file_type
        h["source_header_length"] = input_params.source_header_length
        h["source_header_position"] = 0
        h["source_file_name"] = init_params.image_filename
        h["calibration_file_name"] = init_params.calibration_filename
        h["calibration_threshold_epsilon"] = input_params.calibration_threshold_epsilon
        h["has_calibration_data"] = input_params.keep_calibration_data
        h["frame_offset"] = input_params.frame_offset
        h["calibration_frame_offset"] = input_params.calibration_frame_offset
        h["num_calibration_frames"] = input_params.num_calibration_frames
        h["source_bit_depth"] = input_params.source_bit_depth
        if self._version < 0.2:
            # v0.1 only supports unsigned ints
            h["source_dtype"] = 0
            h["target_dtype"] = 0
        else:
            h["source_dtype"] = input_params.source_data_type
            h["target_dtype"] = input_params.target_data_type
        h["checksum"] = bytes(32)
        h["futures"] = bytes(42 if self._version < 0.2 else 219)

    # --------------------------------------------------------------- serialize

    def serialize(self, rc_filename: str) -> None:
        if not rc_filename:
            raise ValueError("ReCoDe filename missing")
        with open(rc_filename, "wb") as fp:
            self.serialize_to(fp)

    def serialize_to(self, fp: BinaryIO) -> None:
        fp.write(self.to_bytes())

    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        for f in self.fields:
            value = self._values[f.name]
            if f.kind == "int":
                out.write(int(value).to_bytes(f.nbytes, "little"))
            elif f.kind == "str":
                encoded = str(value).encode("utf-8")
                # truncate/pad the encoded BYTES: multi-byte characters would
                # otherwise break the fixed field width
                encoded = encoded[: f.nbytes].ljust(f.nbytes, b" ")
                out.write(encoded)
            else:  # bytes
                b = bytes(value)[: f.nbytes]
                out.write(b.ljust(f.nbytes, b"\x00"))
        return out.getvalue()

    # -------------------------------------------------------------------- load

    def load(self, rc_filename: str, is_intermediate: bool = False) -> None:
        if not rc_filename:
            raise ValueError("ReCoDe filename missing")
        with open(rc_filename, "rb") as fp:
            self.load_from(fp, is_intermediate=is_intermediate)

    def load_from(self, fp: BinaryIO, is_intermediate: bool = False) -> None:
        start = fp.tell()

        # sniff version from the first three fields (uid u64, major u8, minor u8)
        sniff = fp.read(10)
        if len(sniff) < 10:
            raise ValueError("File too short to contain a ReCoDe header")
        uid = int.from_bytes(sniff[0:8], "little")
        major, minor = sniff[8], sniff[9]
        if uid != RECODE_UID:
            raise ValueError(f"Not a ReCoDe file (uid mismatch: {uid})")
        if (major, minor) not in ((0, 1), (0, 2)):
            raise ValueError(
                f"Unsupported ReCoDe version {major}.{minor} "
                "(supported: 0.1, 0.2)")
        self._version = major + minor / 10.0

        fp.seek(start)
        raw = fp.read(self.recode_header_length)
        if len(raw) < self.recode_header_length:
            raise ValueError("Truncated ReCoDe header")

        pos = 0
        for f in self.fields:
            chunk = raw[pos: pos + f.nbytes]
            pos += f.nbytes
            if f.kind == "int":
                self._values[f.name] = int.from_bytes(chunk, "little")
            elif f.kind == "str":
                self._values[f.name] = chunk.decode("utf-8", errors="replace").rstrip()
            else:
                self._values[f.name] = chunk

        # v0.1 lacks several v0.2 fields; synthesize them so downstream code can
        # treat every loaded header uniformly (reference recode_header.py:227-238).
        if self._version < 0.2:
            self._values["is_intermediate"] = int(bool(is_intermediate))
            self._values["is_bit_packed"] = 1
            self._values["frame_metadata_size"] = 0
            self._values["num_non_standard_frame_metadata"] = 0
            self._values["source_header_length"] = 0
            self._values["source_dtype"] = 0
            self._values["target_dtype"] = 0

        # non-standard metadata descriptors: 100 bytes each, 99-byte name + u8
        # size.  The count and length fields come from untrusted bytes: a
        # corrupt u32 must fail clean (truncation error), not spin a 4e9-
        # iteration loop or index past a short read.
        self._non_standard_frame_metadata_sizes = {}
        for _ in range(int(self._values["num_non_standard_frame_metadata"])):
            b = fp.read(100)
            if len(b) < 100:
                raise ValueError(
                    "Truncated ReCoDe header (non-standard metadata "
                    "descriptors extend past end of file)")
            name = b[:99].decode("utf-8", errors="replace").rstrip(" \x00")
            self._non_standard_frame_metadata_sizes[name] = b[99]

        src_len = int(self._values["source_header_length"])
        self._source_header = fp.read(src_len)
        if len(self._source_header) < src_len:
            raise ValueError(
                "Truncated ReCoDe header (source header extends past "
                "end of file)")

    # ----------------------------------------------------------------- offsets

    def get_frame_data_offset(self, is_intermediate: bool, sz_frame_metadata: int) -> int:
        """Byte offset where frame data starts.

        For merged (non-intermediate) files the per-frame metadata table of
        ``nz * sz_frame_metadata`` bytes sits between the headers and the frame
        data (reference recode_header.py:281-291).
        """
        if self._values.get("version_major") == 0 and self._values.get("version_minor") == 1:
            offset = self.recode_header_length
        else:
            offset = (
                self.recode_header_length
                + int(self._values["source_header_length"])
                + len(self._non_standard_frame_metadata_sizes) * 100
            )
        if is_intermediate:
            return offset
        return int(offset + int(self._values["nz"]) * sz_frame_metadata)

    def skip_header(self, rc_fp: BinaryIO) -> BinaryIO:
        rc_fp.seek(self.recode_header_length)
        return rc_fp

    # -------------------------------------------------------------- properties

    @property
    def source_header(self) -> Optional[bytes]:
        return self._source_header

    @property
    def non_standard_metadata_sizes(self) -> Dict[str, int]:
        return self._non_standard_frame_metadata_sizes

    # ------------------------------------------------------------------- misc

    def validate(self) -> bool:
        for f in self.fields:
            if f.name not in self._values:
                print(f"ReCoDe Header Validation Failed: {f.name} is missing.")
                return False
        return True

    def print(self) -> None:
        print("ReCoDe Header")
        print("-------------")
        for f in self.fields:
            print(f.name, "=", self._values.get(f.name))

    def __repr__(self) -> str:
        nz = self._values.get("nz")
        ny = self._values.get("ny")
        nx = self._values.get("nx")
        return (
            f"<ReCoDeHeader v{self._version} L{self._values.get('reduction_level')} "
            f"mode={self._values.get('rc_operation_mode')} shape=({nz},{ny},{nx})>"
        )
