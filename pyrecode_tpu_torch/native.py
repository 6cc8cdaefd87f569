"""ctypes bindings for the native host kernels (native/recode_host.cpp).

The port's own copy of the host half of pyrecode_tpu/native.py: the port
imports nothing of the JAX package.  The C++ source is the repository's
``native/recode_host.cpp``; this module compiles it with ``g++`` into
``pyrecode_tpu_torch/_build/host-<hash>/librecode_host.so``, keyed by a hash
of the source and the flags, and never loads the JAX package's library.

The card does reduction, packing and entropy coding; these C++ loops serve
the host side: the sparse random-access decode of the reader, the host
entropy coders (scheme-0 sparse deflate, scheme-12 rANS) and the per-stream
deflate tables of the device entropy stage (``entropy_host_tables``, or
``dyn_tables``, ``dyn_header`` and ``token_luts_radix`` one at a time);
``bit_pack``, ``bit_unpack`` and ``pack_mask`` serve host packing, and a
``Reader`` shim mirrors the reference's ``c_recode.Reader``
(``create_buffers``, ``get_frame_sparse``, ``bit_pack_pixel_intensities``,
``bit_unpack_pixel_intensities``).  Everything degrades to the numpy oracle where there is one when no compiler
is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "recode_host.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / "librecode_host.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, lib)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or not _SRC.exists():
            _build_failed = True
            return None
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.bit_pack_u16.restype = None
        lib.bit_pack_u16.argtypes = [u16p, ctypes.c_uint64, ctypes.c_uint8, u8p]
        lib.bit_unpack_u64.restype = None
        lib.bit_unpack_u64.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint8, u8p]
        lib.pack_mask.restype = None
        lib.pack_mask.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.dyn_tables.restype = None
        lib.dyn_tables.argtypes = [u32p, u8p, u16p]
        lib.dyn_header.restype = ctypes.c_int64
        lib.dyn_header.argtypes = [u8p, u8p]
        lib.token_luts_radix.restype = None
        lib.token_luts_radix.argtypes = [u8p, u16p, f32p]
        lib.unpack_frame_sparse.restype = ctypes.c_int64
        lib.unpack_frame_sparse.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8, u8p, u8p, u64p,
            ctypes.c_int32]
        lib.label_components_u8.restype = ctypes.c_int32
        lib.label_components_u8.argtypes = [u8p, ctypes.c_uint32,
                                            ctypes.c_uint32, i32p]
        lib.deflate_sparse_dyn.restype = ctypes.c_int64
        lib.deflate_sparse_dyn.argtypes = [u8p, ctypes.c_uint64, u8p, u32p]
        lib.entropy_host_tables.restype = None
        lib.entropy_host_tables.argtypes = [u32p, u8p, f32p, i64p]
        lib.rans_compress.restype = ctypes.c_int64
        lib.rans_compress.argtypes = [u8p, ctypes.c_uint64, u8p, u32p,
                                      ctypes.c_uint32]
        lib.rans_decompress.restype = ctypes.c_int64
        lib.rans_decompress.argtypes = [u8p, ctypes.c_uint64, u8p,
                                        ctypes.c_uint64]
        lib.rans_reconstruct.restype = ctypes.c_int64
        lib.rans_reconstruct.argtypes = [i32p, ctypes.c_uint64, u8p,
                                         ctypes.c_uint64, u8p,
                                         ctypes.c_uint64]
        lib.rans_compress_symbols.restype = ctypes.c_int64
        lib.rans_compress_symbols.argtypes = [u8p, ctypes.c_uint64,
                                              ctypes.c_uint32,
                                              ctypes.c_uint32, u8p]
        lib.rans_decompress_symbols.restype = ctypes.c_int64
        lib.rans_decompress_symbols.argtypes = [u8p, ctypes.c_uint64, u8p,
                                                ctypes.c_uint64]
        lib.rans_compress_gaps.restype = ctypes.c_int64
        lib.rans_compress_gaps.argtypes = [u8p, ctypes.c_uint64,
                                           ctypes.c_uint32, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _padded_u8(buf: bytes, pad: int = 8) -> np.ndarray:
    """Copy into a uint8 array with `pad` guard bytes (the C kernels use
    unaligned 64-bit window reads that may touch up to 7 bytes past the
    data)."""
    arr = np.zeros(len(buf) + pad, dtype=np.uint8)
    arr[: len(buf)] = np.frombuffer(buf, dtype=np.uint8)
    return arr


def unpack_frame_sparse(bitmap: bytes, pixvals: Optional[bytes], ny: int, nx: int,
                        bit_depth: int, reduction_level: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native decode to (rows, cols, values); falls back to the oracle.

    Depths above 16 bits take the oracle path: the C kernel extracts values
    through an unaligned 64-bit window (correct only to 57 bits) and its
    encode counterpart is u16-only.
    """
    lib = get_lib()
    if lib is None or bit_depth > 16:
        from . import oracle

        return oracle.decode_frame_sparse(bitmap, pixvals, ny, nx, bit_depth,
                                          reduction_level, dtype=np.uint64)
    bm = _padded_u8(bitmap)
    pv = _padded_u8(pixvals) if pixvals is not None else None
    # worst case: every pixel foreground
    out = np.empty((ny * nx, 3), dtype=np.uint64)
    n = lib.unpack_frame_sparse(
        ctypes.c_uint32(ny), ctypes.c_uint32(nx), ctypes.c_uint8(bit_depth),
        _u8ptr(bm), _u8ptr(pv) if pv is not None else None,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int32(reduction_level))
    trip = out[:n]
    return trip[:, 0].copy(), trip[:, 1].copy(), trip[:, 2].copy()


def bit_pack(values: np.ndarray, bit_depth: int) -> np.ndarray:
    """Native b-bit LSB-first packing; falls back to the oracle.

    The C kernel reads u16 inputs, so depths above 16 bits go to the oracle.
    """
    lib = get_lib()
    if lib is None or bit_depth > 16:
        from . import oracle

        return oracle.bit_pack(values, bit_depth)
    vals = np.ascontiguousarray(values, dtype=np.uint16)
    n_out = -(-vals.size * bit_depth // 8)
    out = np.zeros(n_out + 8, dtype=np.uint8)
    lib.bit_pack_u16(vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                     ctypes.c_uint64(vals.size), ctypes.c_uint8(bit_depth),
                     _u8ptr(out))
    return out[:n_out]


def bit_unpack(packed: bytes, bit_depth: int, n_values: int, dtype=np.uint64) -> np.ndarray:
    """Native b-bit unpack; falls back to the oracle (always for depth > 16,
    where the C unaligned-64-bit-window extraction would go wrong past 57
    bits and asymmetry with the u16-only packer serves no one)."""
    lib = get_lib()
    if lib is None or bit_depth > 16:
        from . import oracle

        return oracle.bit_unpack(packed, bit_depth, n_values, dtype=dtype)
    src = _padded_u8(bytes(packed))
    out = np.empty(n_values, dtype=np.uint64)
    lib.bit_unpack_u64(_u8ptr(src), ctypes.c_uint64(n_values),
                       ctypes.c_uint8(bit_depth), _u8ptr(out.view(np.uint8)))
    return out.astype(dtype)


def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """Native 8-connected component labeling, labels in row-major
    first-encounter order; falls back to the scipy-based oracle."""
    lib = get_lib()
    if lib is None:
        from . import oracle

        return oracle.label_components(mask)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    ny, nx = m.shape
    labels = np.empty((ny, nx), np.int32)
    n = lib.label_components_u8(
        _u8ptr(m), ctypes.c_uint32(ny), ctypes.c_uint32(nx),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, int(n)


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """Native binary-map packing; falls back to the oracle."""
    lib = get_lib()
    if lib is None:
        from . import oracle

        return oracle.pack_binary_frame(mask)
    flat = np.ascontiguousarray(mask, dtype=np.uint8).reshape(-1)
    out = np.zeros((flat.size + 7) // 8, dtype=np.uint8)
    lib.pack_mask(_u8ptr(flat), ctypes.c_uint64(flat.size), _u8ptr(out))
    return out


def deflate_sparse(data) -> bytes:
    """zlib-compatible sparse-deflate encode; falls back to zlib level 1.

    Dynamic-Huffman run-length encoder specialized for the codec's streams;
    output is a valid zlib stream that any inflate decodes, and degrades to
    stored blocks (raw + 5 bytes per 64K) on incompressible data.
    """
    lib = get_lib()
    buf = bytes(data)
    if lib is None:
        import zlib

        return zlib.compress(buf, 1)
    src = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    out = np.empty(len(buf) * 2 + 320, dtype=np.uint8)
    tokens = np.empty(len(buf) + 16, dtype=np.uint32)
    n = lib.deflate_sparse_dyn(
        _u8ptr(src), ctypes.c_uint64(src.size), _u8ptr(out),
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out[:n].tobytes()


def rans_compress(data, nways: int = 512) -> bytes:
    """Scheme-12 (interleaved rANS) byte-mode encode; byte-identical to
    ``codecs.rans.compress``, which it falls back to without the library."""
    lib = get_lib()
    buf = bytes(data)
    if lib is None:
        from .codecs import rans as _rans

        return _rans.compress(buf, nways=nways)
    src = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    out = np.empty(len(buf) + 4096 + 4 * nways, dtype=np.uint8)
    tokens = np.empty(len(buf) + 16, dtype=np.uint32)
    n = lib.rans_compress(
        _u8ptr(src), ctypes.c_uint64(src.size), _u8ptr(out),
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_uint32(nways))
    return out[:n].tobytes()


def rans_compress_symbols_native(data, sym_bits: int, nways: int
                                 ) -> Optional[bytes]:
    """Coded-form symbol-mode stream via the C encoder, or None when the
    library is missing / symbol coding is inapplicable (the caller falls
    back and applies the byte-mode/stored decision)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(data)
    src = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    out = np.empty(2 * len(buf) + 64 + 4 * nways + 4 * 4096 + 4096,
                   dtype=np.uint8)
    n = lib.rans_compress_symbols(
        _u8ptr(src), ctypes.c_uint64(src.size), ctypes.c_uint32(sym_bits),
        ctypes.c_uint32(nways), _u8ptr(out))
    if n < 0:
        return None
    return out[:n].tobytes()


def rans_compress_gaps_native(bitmap, nways: int) -> Optional[bytes]:
    """Gap-mode (flags 2|4) scheme-12 stream of an LSB-first bitmap via the
    C encoder, or None when the library is missing / gap coding cannot win
    (empty bitmap, or set bits outnumber bytes)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(bitmap)
    src = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    out = np.empty(2 * len(buf) + 64 + 4 * max(int(nways), 8) + 4 * 4096
                   + 4096, dtype=np.uint8)
    n = lib.rans_compress_gaps(
        _u8ptr(src), ctypes.c_uint64(src.size), ctypes.c_uint32(nways),
        _u8ptr(out))
    if n < 0:
        return None
    return out[:n].tobytes()


def rans_decompress(stream) -> bytes:
    """Scheme-12 decode (native; numpy fallback)."""
    lib = get_lib()
    buf = bytes(stream)
    if lib is None:
        from .codecs import rans as _rans

        return _rans.decompress(buf)
    if len(buf) < 8 or buf[0] != 0xA5:
        raise ValueError("not a TPU-rANS stream")
    n = int.from_bytes(buf[4:8], "little")
    src = np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8))
    out = np.empty(max(n, 1), dtype=np.uint8)
    if buf[3] & 2:
        got = lib.rans_decompress_symbols(
            _u8ptr(src), ctypes.c_uint64(src.size), _u8ptr(out),
            ctypes.c_uint64(out.size))
    else:
        got = lib.rans_decompress(_u8ptr(src), ctypes.c_uint64(src.size),
                                  _u8ptr(out), ctypes.c_uint64(out.size))
    if got < 0:
        raise ValueError("TPU-rANS stream corrupt")
    return out[:got].tobytes()


def rans_reconstruct(syms: np.ndarray, xbits: bytes, n: int
                     ) -> Optional[bytes]:
    """Byte-mode symbols + extra bits -> raw bytes.

    Returns None when the native library is unavailable (callers fall back
    to the numpy path); raises on malformed input.  The adler check is the
    caller's (codecs/rans._reconstruct_bytes)."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(np.asarray(syms), dtype=np.int32)
    xb = np.frombuffer(bytes(xbits), dtype=np.uint8) if xbits else \
        np.zeros(0, np.uint8)
    out = np.empty(max(int(n), 1), dtype=np.uint8)
    got = lib.rans_reconstruct(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_uint64(s.size), _u8ptr(np.ascontiguousarray(xb)),
        ctypes.c_uint64(xb.size), _u8ptr(out), ctypes.c_uint64(int(n)))
    if got < 0:
        raise ValueError("TPU-rANS symbol stream corrupt")
    return out[: int(n)].tobytes()


def dyn_tables(lfreq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical dynamic-Huffman tables from 286 literal/length frequencies.

    Exactly the construction used by :func:`deflate_sparse` dynamic mode
    (heap tie-breaking included), so streams assembled from these tables are
    byte-identical to ``deflate_sparse_dyn`` output.  Returns (llen u8[286],
    lcode u16[286]).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    freq = np.ascontiguousarray(lfreq, dtype=np.uint32)
    assert freq.size == 286
    llen = np.zeros(286, dtype=np.uint8)
    lcode = np.zeros(286, dtype=np.uint16)
    lib.dyn_tables(freq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                   _u8ptr(llen),
                   lcode.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return llen, lcode


def dyn_header(llen: np.ndarray) -> Tuple[np.ndarray, int]:
    """zlib header + dynamic block header bits for literal/length lengths.

    Returns (bytes u8[ceil(bits/8)], bit_length); the final byte is partial
    (zero-padded) unless bit_length % 8 == 0.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    lens = np.ascontiguousarray(llen, dtype=np.uint8)
    out = np.zeros(512, dtype=np.uint8)
    bits = int(lib.dyn_header(_u8ptr(lens), _u8ptr(out)))
    return out[: (bits + 7) // 8], bits


def token_luts_radix(llen: np.ndarray, lcode: np.ndarray
                     ) -> Optional[np.ndarray]:
    """Token (value, bit-count) LUT in the assembly kernel's radix layout.

    Returns a (48, 32) f32 LUT — rows 0..23 full token values
    (exact in f32, <= 21 bits), rows 24..47 bit counts, both laid out
    [idx >> 5, idx & 31] — or None when the native library is unavailable.
    ``entropy_host_tables`` computes it with the two tables in one call.
    """
    lib = get_lib()
    if lib is None:
        return None
    lens = np.ascontiguousarray(llen, dtype=np.uint8)
    codes = np.ascontiguousarray(lcode, dtype=np.uint16)
    lut = np.zeros((48, 32), dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.token_luts_radix(_u8ptr(lens),
                         codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                         lut.ctypes.data_as(f32p))
    return lut


def entropy_host_tables(lfreq_body: np.ndarray, lut_out: np.ndarray
                        ) -> Optional[Tuple[np.ndarray, int, int, int, int]]:
    """The per-stream host step of the device deflate in one call.

    ``lfreq_body`` — 286 literal/length frequencies (end-of-block NOT yet
    counted; added inside).  Writes the (48, 32) f32 token LUT (rows 0..23
    token values, 24..47 bit counts, laid out [idx >> 5, idx & 31]) into
    ``lut_out`` in place and returns (header bytes, header_bits, eob_val,
    eob_len, body_bits); None when the native library is unavailable.  The
    canonical Huffman construction is the one of :func:`deflate_sparse`, so
    streams built from these tables are byte-identical to it.
    """
    lib = get_lib()
    if lib is None:
        return None
    freq = np.ascontiguousarray(lfreq_body, dtype=np.uint32)
    assert freq.size == 286
    hdr = np.zeros(512, dtype=np.uint8)
    info = np.zeros(4, dtype=np.int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.entropy_host_tables(
        freq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), _u8ptr(hdr),
        lut_out.ctypes.data_as(f32p),
        info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    bits = int(info[0])
    return (hdr[: (bits + 7) // 8], bits, int(info[1]), int(info[2]),
            int(info[3]))


class Reader:
    """API shim mirroring the reference ``c_recode.Reader``
    (pyrecode.cpp:57-149)."""

    def __init__(self):
        self._ny = self._nx = self._bit_depth = 0

    def create_buffers(self, ny: int, nx: int, bit_depth: int) -> None:
        self._ny, self._nx, self._bit_depth = int(ny), int(nx), int(bit_depth)

    def get_frame_sparse(self, reduction_level, binary_map, pixvals, frame_buffer) -> int:
        rows, cols, vals = unpack_frame_sparse(
            bytes(binary_map), bytes(pixvals) if pixvals is not None else None,
            self._ny, self._nx, self._bit_depth, int(reduction_level))
        n = rows.size
        triplets = np.empty((n, 3), dtype=np.uint64)
        triplets[:, 0] = rows
        triplets[:, 1] = cols
        triplets[:, 2] = vals
        view = np.frombuffer(frame_buffer, dtype=np.uint64)
        view[: n * 3] = triplets.reshape(-1)
        return n

    def bit_pack_pixel_intensities(self, sz_packed, n_fg, bit_depth, pixvals, packed) -> float:
        vals = np.frombuffer(pixvals, dtype=np.uint16, count=int(n_fg))
        out = bit_pack(vals, int(bit_depth))
        view = np.frombuffer(packed, dtype=np.uint8)
        view[: out.size] = out
        return 0.0

    def bit_unpack_pixel_intensities(self, n_values, packed, buffer) -> float:
        out = bit_unpack(bytes(packed), self._bit_depth, int(n_values))
        view = np.frombuffer(buffer, dtype=np.uint64)
        view[: out.size] = out
        return 0.0
