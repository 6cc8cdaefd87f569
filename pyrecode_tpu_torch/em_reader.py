"""EM source-file readers: MRC, StreamPix SEQ, raw binary.

The port's own copy of pyrecode_tpu/em_reader.py: the port imports nothing of the
JAX package.

Capability parity with the reference ``pyrecode/em_reader.py``: the abstract
``EMReaderBase`` iteration/slicing protocol (em_reader.py:36-184), an
``MRCReader`` (em_reader.py:187-240), a ``SEQReader`` (em_reader.py:243-304)
and the ``emfile`` factory (em_reader.py:11-34).

Unlike the reference, which delegates to mrcfile/pims, both formats are
parsed natively by default — MRC2014 and StreamPix v5 are fixed-offset
binary headers — so detector files load with zero third-party dependencies.
mrcfile/pims remain optional fallbacks for exotic variants the minimal
parsers reject.
"""

from __future__ import annotations

import os
import struct
from abc import abstractmethod

import numpy as np

from .constants import rc_cfg as rc

DEFAULT_BUFFER_SIZE = 8 * 1024  # bytes

# MRC2014 mode -> numpy dtype (mrc2014.pdf table 1; reference reads via
# mrcfile which applies the same map)
_MRC_MODE_DTYPES = {
    0: np.int8,
    1: np.int16,
    2: np.float32,
    6: np.uint16,
    12: np.float16,
}

SEQ_HEADER_SIZE = 8192   # StreamPix v5+: images start at this offset
_SEQ_MAGIC = 0xFEED


def parse_mrc_header(raw: bytes) -> dict:
    """Parse the fixed 1024-byte MRC2014 header (little-endian).

    Raises ValueError on non-MRC bytes.  Returns the classic fields keyed as
    mrcfile names them (nx/ny/nz/mode/nsymbt/...), plus ``_data_offset`` and
    ``_numpy_dtype``.
    """
    if len(raw) < 1024:
        raise ValueError("MRC header must be 1024 bytes")
    nx, ny, nz, mode = struct.unpack_from("<4i", raw, 0)
    nsymbt = struct.unpack_from("<i", raw, 92)[0]
    map_id = raw[208:212]
    machst = raw[212:216]
    if map_id not in (b"MAP ", b"MAP\x00"):
        # pre-2014 files may miss the MAP stamp; sanity-check dims instead
        if not (0 < nx < (1 << 20) and 0 < ny < (1 << 20) and 0 <= nz < (1 << 20)
                and mode in _MRC_MODE_DTYPES):
            raise ValueError("not an MRC file (no MAP stamp, implausible dims)")
    if machst[:2] == b"\x11\x11":
        raise ValueError("big-endian MRC files are not supported by the "
                         "native parser")
    if mode not in _MRC_MODE_DTYPES:
        raise ValueError(f"unsupported MRC mode {mode}")
    header = {
        "nx": nx, "ny": ny, "nz": nz, "mode": mode,
        "nxstart": struct.unpack_from("<i", raw, 16)[0],
        "nystart": struct.unpack_from("<i", raw, 20)[0],
        "nzstart": struct.unpack_from("<i", raw, 24)[0],
        "mx": struct.unpack_from("<i", raw, 28)[0],
        "my": struct.unpack_from("<i", raw, 32)[0],
        "mz": struct.unpack_from("<i", raw, 36)[0],
        "nsymbt": nsymbt,
        "exttyp": raw[104:108],
        "nversion": struct.unpack_from("<i", raw, 108)[0],
        "map": map_id,
        "_data_offset": 1024 + nsymbt,
        "_numpy_dtype": np.dtype(_MRC_MODE_DTYPES[mode]),
    }
    return header


def parse_seq_header(raw: bytes) -> dict:
    """Parse a StreamPix (Norpix) .seq header (fixed offsets, v4/v5+).

    Keys match what the reference reads off pims' ``header_dict``
    (allocated_frames/height/width/bit_depth, em_reader.py:258-268).
    """
    if len(raw) < 1024:
        raise ValueError("SEQ header must be at least 1024 bytes")
    magic = struct.unpack_from("<I", raw, 0)[0]
    if magic != _SEQ_MAGIC:
        raise ValueError(f"not a StreamPix sequence (magic {magic:#x})")
    version = struct.unpack_from("<i", raw, 28)[0]
    header_size = struct.unpack_from("<i", raw, 32)[0]
    width = struct.unpack_from("<I", raw, 548)[0]
    height = struct.unpack_from("<I", raw, 552)[0]
    bit_depth = struct.unpack_from("<I", raw, 556)[0]
    bit_depth_real = struct.unpack_from("<I", raw, 560)[0]
    image_size = struct.unpack_from("<I", raw, 564)[0]
    image_format = struct.unpack_from("<I", raw, 568)[0]
    allocated_frames = struct.unpack_from("<I", raw, 572)[0]
    origin = struct.unpack_from("<I", raw, 576)[0]
    true_image_size = struct.unpack_from("<I", raw, 580)[0]
    image_offset = SEQ_HEADER_SIZE if version >= 5 else 1024
    return {
        "magic": magic,
        "version": version,
        "header_size": header_size,
        "description": raw[36:548].split(b"\x00", 1)[0].decode("latin-1"),
        "width": width,
        "height": height,
        "bit_depth": bit_depth,
        "bit_depth_real": bit_depth_real,
        "image_size_bytes": image_size,
        "image_format": image_format,
        "allocated_frames": allocated_frames,
        "origin": origin,
        "true_image_size": true_image_size if true_image_size else image_size,
        "_image_offset": image_offset,
    }


def emfile(file, file_type=None, mode="r", buffering=-1):
    """Open an EM source file by type code (0 binary / 1 MRC / 2 SEQ)."""
    if mode != "r":
        raise NotImplementedError("emfile supports only 'r' mode.")
    if file_type == rc.FILE_TYPE_MRC:
        return MRCReader(file)
    if file_type == rc.FILE_TYPE_SEQ:
        return SEQReader(file)
    if file_type == rc.FILE_TYPE_BINARY:
        raise NotImplementedError(
            "raw binary sources are read via fileutils.read_file with explicit geometry")
    raise ValueError(f"Source type {file_type!r} is not supported.")


def write_mrc(path, data: np.ndarray) -> None:
    """Write a minimal MRC2014 stack (validation/fixture tooling).

    Not in the reference (it only reads); used by tests and by stream-mode
    examples to synthesize detector files the native parser reads back.
    """
    data = np.ascontiguousarray(data)
    if data.ndim == 2:
        data = data[np.newaxis]
    mode = {np.dtype(np.int8): 0, np.dtype(np.int16): 1,
            np.dtype(np.float32): 2, np.dtype(np.uint16): 6,
            np.dtype(np.float16): 12}[data.dtype]
    nz, ny, nx = data.shape
    header = bytearray(1024)
    struct.pack_into("<4i", header, 0, nx, ny, nz, mode)
    struct.pack_into("<3i", header, 28, nx, ny, nz)      # mx, my, mz
    struct.pack_into("<i", header, 92, 0)                # nsymbt
    struct.pack_into("<i", header, 108, 20140)           # nversion
    header[208:212] = b"MAP "
    header[212:216] = bytes((0x44, 0x44, 0x00, 0x00))    # little-endian stamp
    with open(path, "wb") as fp:
        fp.write(bytes(header))
        fp.write(data.tobytes())


def write_seq(path, data: np.ndarray, timestamp_pad: int = 8) -> None:
    """Write a minimal StreamPix v5 sequence (validation/fixture tooling)."""
    data = np.ascontiguousarray(data)
    if data.ndim == 2:
        data = data[np.newaxis]
    bit_depth = data.dtype.itemsize * 8
    nz, ny, nx = data.shape
    image_size = ny * nx * data.dtype.itemsize
    true_size = image_size + timestamp_pad
    header = bytearray(SEQ_HEADER_SIZE)
    struct.pack_into("<I", header, 0, _SEQ_MAGIC)
    header[4:15] = b"Norpix seq\x00"
    struct.pack_into("<i", header, 28, 5)                # version
    struct.pack_into("<i", header, 32, SEQ_HEADER_SIZE)  # header size
    struct.pack_into("<I", header, 548, nx)
    struct.pack_into("<I", header, 552, ny)
    struct.pack_into("<I", header, 556, bit_depth)
    struct.pack_into("<I", header, 560, bit_depth)
    struct.pack_into("<I", header, 564, image_size)
    struct.pack_into("<I", header, 568, 100)             # monochrome
    struct.pack_into("<I", header, 572, nz)              # allocated frames
    struct.pack_into("<I", header, 580, true_size)
    with open(path, "wb") as fp:
        fp.write(bytes(header))
        for i in range(nz):
            fp.write(data[i].tobytes())
            fp.write(bytes(timestamp_pad))


class EMReaderBase:
    """Base class: header/shape/dtype properties, iteration, numpy-style
    slicing returning frame stacks."""

    def __init__(self, file, source_type="", fast_random_access=False,
                 buffer_size=DEFAULT_BUFFER_SIZE):
        self._source_filename = file
        self._source_type = source_type
        self._open()
        self._header = self._load_header()
        self._shape = self._get_shape()
        self._dtype = self._get_dtype()
        self.buffer_size = buffer_size
        self._fast_random_access = fast_random_access
        self._current_z = 0

    source_type = property(lambda self: self._source_type)
    shape = property(lambda self: self._shape)
    header = property(lambda self: self._header)
    dtype = property(lambda self: self._dtype)
    fast_random_access = property(lambda self: self._fast_random_access)

    @abstractmethod
    def _open(self):
        ...

    @abstractmethod
    def _load_header(self):
        ...

    @abstractmethod
    def _get_shape(self):
        ...

    @abstractmethod
    def _get_dtype(self):
        ...

    @abstractmethod
    def _get_frame(self, z_index):
        ...

    @abstractmethod
    def _get_sub_volume(self, slice_z, slice_y, slice_x):
        ...

    @abstractmethod
    def get_true_shape(self):
        ...

    @abstractmethod
    def close(self):
        ...

    @abstractmethod
    def serialize_header(self, fp):
        ...

    def __iter__(self):
        return self

    def __next__(self):
        if self._current_z >= self.shape[0]:
            raise StopIteration
        self._current_z += 1
        return self._get_frame(self._current_z - 1)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            if len(key) == 3:
                return self._get_sub_volume(key[0], key[1], key[2])
            if len(key) == 2:
                return self._get_sub_volume(key[0], key[1], slice(0, self._shape[2]))
            return self._get_sub_volume(key[0], slice(0, self._shape[1]),
                                        slice(0, self._shape[2]))
        if isinstance(key, slice):
            return self._get_sub_volume(key, slice(0, self._shape[1]),
                                        slice(0, self._shape[2]))
        if isinstance(key, (int, np.integer)):
            if key >= self._shape[0]:
                raise IndexError(key)
            return self._get_frame(int(key))
        raise TypeError(type(key))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.close()

    def print_header(self):
        for field, value in self._header.items():
            print(f"{field}:\t{value}")


class MRCReader(EMReaderBase):
    """MRC/MRCS stacks — native MRC2014 parser, mrcfile as fallback.

    The reference delegates entirely to mrcfile (em_reader.py:187-240); here
    the fixed 1024-byte header is parsed directly and frame data is memory-
    mapped, so MRC sources need no third-party package.
    """

    def __init__(self, file):
        self._via_mrcfile = False
        super().__init__(file, "mrc", False)

    def _open(self):
        with open(self._source_filename, "rb") as fp:
            self._raw_header = fp.read(1024)

    def _load_header(self):
        try:
            header = parse_mrc_header(self._raw_header)
        except ValueError:
            return self._load_via_mrcfile()
        nz = max(int(header["nz"]), 1)
        self._stack = np.memmap(
            self._source_filename, dtype=header["_numpy_dtype"], mode="r",
            offset=header["_data_offset"],
            shape=(nz, int(header["ny"]), int(header["nx"])))
        return header

    def _load_via_mrcfile(self):
        try:
            import mrcfile
        except ImportError as e:
            raise ValueError(
                "file is not minimal MRC2014 and mrcfile is not installed") from e
        try:
            handle = mrcfile.open(self._source_filename, mode="r")
        except ValueError:
            handle = mrcfile.open(self._source_filename, mode="r", permissive=True)
        self._via_mrcfile = True
        self._file_handle = handle
        data = handle.data
        self._stack = data if data.ndim == 3 else data[np.newaxis]
        record = handle.header
        return {name: record[name] for name in record.dtype.names}

    def _get_shape(self):
        return (max(int(self._header["nz"]), 1), int(self._header["ny"]),
                int(self._header["nx"]))

    def get_true_shape(self):
        return self._stack.shape

    def _get_dtype(self):
        return self._stack.dtype

    def _get_sub_volume(self, slice_z, slice_y, slice_x):
        return np.asarray(self._stack[slice_z, slice_y, slice_x])

    def _get_frame(self, z_index):
        return np.asarray(self._stack[z_index][np.newaxis, :, :])

    def close(self):
        if self._via_mrcfile:
            self._file_handle.close()
        else:
            self._stack = None  # release the memmap

    def serialize_header(self, fp):
        # the raw 1024-byte MRC header
        fp.write(self._raw_header[:1024].ljust(1024, b"\x00"))


class SEQReader(EMReaderBase):
    """StreamPix .seq stacks — native Norpix v4/v5 parser, pims as fallback.

    The reference delegates to pims (em_reader.py:243-304); here the fixed-
    offset header is parsed directly and frames are read with seeks, so SEQ
    sources need no third-party package.
    """

    def __init__(self, file, buffer_size=DEFAULT_BUFFER_SIZE):
        self._via_pims = False
        super().__init__(file, "seq", False, buffer_size)

    def _open(self):
        self._fp = open(self._source_filename, "rb")
        self._raw_header = self._fp.read(1024)

    def _load_header(self):
        try:
            return parse_seq_header(self._raw_header)
        except ValueError:
            self._fp.close()
            return self._load_via_pims()

    def _load_via_pims(self):
        try:
            import pims
        except ImportError as e:
            raise ValueError(
                "file is not StreamPix v4/v5 and pims is not installed") from e
        self._stack = pims.open(self._source_filename)
        self._via_pims = True
        return dict(self._stack.header_dict)

    def _get_shape(self):
        h = self._header
        return (int(h["allocated_frames"]), int(h["height"]), int(h["width"]))

    def get_true_shape(self):
        if self._via_pims:
            frame = self._stack[0]
            return (len(self._stack), frame.shape[0], frame.shape[1])
        size = os.fstat(self._fp.fileno()).st_size
        n = max((size - self._header["_image_offset"])
                // self._header["true_image_size"], 0)
        return (int(n), self._shape[1], self._shape[2])

    def _get_dtype(self):
        depth = self._header["bit_depth"]
        if depth == 8:
            return np.uint8
        if depth == 16:
            return np.int16  # match the reference's mapping (em_reader.py:273)
        raise TypeError(f"Sequence datasets with bit-depth {depth} are not supported.")

    def _read_frame_native(self, z_index):
        h = self._header
        ny, nx = self._shape[1], self._shape[2]
        frame_bytes = ny * nx * np.dtype(self._dtype).itemsize
        self._fp.seek(h["_image_offset"] + z_index * h["true_image_size"])
        raw = self._fp.read(frame_bytes)
        if len(raw) < frame_bytes:
            raise IndexError(z_index)
        return np.frombuffer(raw, dtype=self._dtype).reshape(ny, nx)

    def _get_frame(self, z_index):
        container = np.zeros((1, self._shape[1], self._shape[2]), dtype=self._dtype)
        container[0] = self._stack[z_index] if self._via_pims \
            else self._read_frame_native(z_index)
        return container

    def _get_sub_volume(self, slice_z, slice_y, slice_x):
        z_indices = range(*slice_z.indices(self._shape[0]))
        ny = len(range(*slice_y.indices(self._shape[1])))
        nx = len(range(*slice_x.indices(self._shape[2])))
        container = np.zeros((len(z_indices), ny, nx), dtype=self._dtype)
        for index, z in enumerate(z_indices):
            frame = self._stack[z] if self._via_pims \
                else self._read_frame_native(z)
            container[index] = frame[slice_y, slice_x]
        return container

    def close(self):
        if self._via_pims:
            self._stack.close()
        self._fp.close()

    def serialize_header(self, fp):
        # the reference serializes a 1024-byte placeholder (em_reader.py:300-304)
        fp.write(bytes(1024))
