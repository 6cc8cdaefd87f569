"""Shared constants and dtype code maps.

The port's own copy of pyrecode_tpu/constants.py: the port imports nothing of the
JAX package.

Capability parity with the reference's ``pyrecode/misc.py`` (rc_cfg at
misc.py:4-38, dtype maps at misc.py:41-95): request types, source-file-type
codes, node status codes, message types, and the (data_type, bit_depth) ->
numpy dtype mapping that is frozen into file headers.
"""

from __future__ import annotations

import numpy as np


class rc_cfg:
    """Codes shared between the container format and the server control plane."""

    REQ_TYPE_QUERY = 0
    REQ_TYPE_COMMAND = 1

    # source_file_type / calibration_file_type codes stored in the header
    FILE_TYPE_BINARY = 0
    FILE_TYPE_MRC = 1
    FILE_TYPE_SEQ = 2
    FILE_TYPE_OTHER = 255

    # node status lifecycle: NOT_READY -> AVAILABLE -> (BUSY <-> AVAILABLE)* -> IS_CLOSED
    STATUS_CODE_BUSY = 0          # processing a request; alive but not listening
    STATUS_CODE_AVAILABLE = 1     # listening
    STATUS_CODE_ERROR = -1        # dead due to exception
    STATUS_CODE_NOT_READY = -2    # has not started yet
    STATUS_CODE_IS_CLOSED = -3    # shut down cleanly

    STATUS_CODES = {
        "STATUS_CODE_BUSY": STATUS_CODE_BUSY,
        "STATUS_CODE_AVAILABLE": STATUS_CODE_AVAILABLE,
        "STATUS_CODE_ERROR": STATUS_CODE_ERROR,
        "STATUS_CODE_NOT_READY": STATUS_CODE_NOT_READY,
        "STATUS_CODE_IS_CLOSED": STATUS_CODE_IS_CLOSED,
    }

    MESSAGE_TYPE_INFO = 0
    MESSAGE_TYPE_ERROR = -1
    MESSAGE_TYPE_STATUS = 1
    MESSAGE_TYPE_ACK = 2

    MESSAGE_TYPES = {
        "MESSAGE_TYPE_INFO": MESSAGE_TYPE_INFO,
        "MESSAGE_TYPE_ERROR": MESSAGE_TYPE_ERROR,
        "MESSAGE_TYPE_STATUS": MESSAGE_TYPE_STATUS,
        "MESSAGE_TYPE_ACK": MESSAGE_TYPE_ACK,
    }


# data_type codes used in headers: 0 = unsigned int, 1 = signed int, 2 = float
_UNSIGNED, _SIGNED, _FLOAT = 0, 1, 2

_UNSIGNED_BY_DEPTH = ((8, np.uint8), (16, np.uint16), (32, np.uint32), (64, np.uint64))
_SIGNED_BY_DEPTH = ((8, np.int8), (16, np.int16), (32, np.int32), (64, np.int64))
_FLOAT_BY_DEPTH = ((32, np.float32), (64, np.float64))


def map_dtype(data_type: int, bit_depth: int):
    """Map a (data_type code, bit depth) pair to the smallest numpy dtype that holds it."""
    table = {_UNSIGNED: _UNSIGNED_BY_DEPTH, _SIGNED: _SIGNED_BY_DEPTH, _FLOAT: _FLOAT_BY_DEPTH}.get(data_type)
    if table is not None:
        for depth, dt in table:
            if bit_depth <= depth:
                return dt
    raise ValueError(
        f"Unable to match a numpy dtype for type = {data_type} "
        f"(0=unsigned int, 1=signed int, 2=float) with bit depth = {bit_depth}"
    )


_DTYPE_CODES = {
    np.uint8: 0, np.uint16: 1, np.uint32: 2, np.uint64: 3,
    np.int8: 4, np.int16: 5, np.int32: 6, np.int64: 7,
    np.float32: 8, np.float64: 9,
}

_DTYPE_STRINGS = {
    0: "uint8", 1: "uint16", 2: "uint32", 3: "uint64",
    4: "int8", 5: "int16", 6: "int32", 7: "int64",
    8: "float32", 9: "float64",
}


def get_dtype_code(dtype) -> int:
    """Numpy dtype (class or instance) -> header dtype code."""
    key = np.dtype(dtype).type
    try:
        return _DTYPE_CODES[key]
    except KeyError:
        raise ValueError(f"Unknown dtype: {dtype!r}") from None


def get_dtype_string(code) -> str:
    """Header dtype code -> numpy dtype name."""
    try:
        return _DTYPE_STRINGS[int(code)]
    except (KeyError, TypeError):
        raise ValueError(f"Unknown dtype code: {code!r}") from None
