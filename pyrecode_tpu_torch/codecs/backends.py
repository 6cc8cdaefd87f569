"""Host-side entropy backends for all 12 ReCoDe compression scheme codes.

The port's own copy of pyrecode_tpu/codecs/backends.py: the port imports nothing of the
JAX package.

Scheme code map (reference recode_compressors.py:4-5, 82-120):

    0  zlib          1  zstandard      2  lz4 (frame)    3  snappy
    4  bz2           5  lzma           6  blosc+zlib     7  blosc+zstd
    8  blosc+lz4     9  blosc+snappy   10 blosclz        11 blosc+lz4hc
    12 tpu-rans      (pyrecode-tpu extension: interleaved rANS whose encode
                      AND decode run as device kernels; codecs/rans.py)

Blosc variants use BITSHUFFLE, matching the reference.  zstd compresses
through a reusable context created with ``write_content_size=False``
(reference recode_writer.py:175-179), which the frame-oriented container
relies on (sizes live in the per-frame metadata, not the stream).

These codecs operate on the *reduced* byte streams (bit-packed binary maps
and packed pixel intensities).  They run on host because entropy coding is a
bit-serial, data-dependent transform that does not map onto the TPU's vector
units; the TPU does the reduction and packing, the host does entropy + IO.
Frame-level parallelism across host cores is provided by the writer's
compression pool (writer.py), since all these libraries release the GIL.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

_availability: Dict[str, bool] = {"zlib": True, "bz2": True, "lzma": True}

try:
    import zstandard as _zstd

    _availability["zstandard"] = True
except ImportError:  # pragma: no cover - environment dependent
    _zstd = None
    _availability["zstandard"] = False

try:
    import lz4.frame as _lz4_frame

    _availability["lz4"] = True
except ImportError:  # pragma: no cover
    _lz4_frame = None
    _availability["lz4"] = False

try:
    import snappy as _snappy

    _availability["snappy"] = True
except ImportError:  # pragma: no cover
    _snappy = None
    _availability["snappy"] = False

try:
    import blosc as _blosc

    _availability["blosc"] = True
except ImportError:  # pragma: no cover
    _blosc = None
    _availability["blosc"] = False

# pure-python fallbacks keep schemes 2, 3, 6-11 executable without the C
# bindings (format-conformant; see codecs/purepy.py for limits)
from . import purepy as _purepy

_FALLBACK = {name: not _availability[name] for name in ("lz4", "snappy", "blosc")}
for _name in ("lz4", "snappy", "blosc"):
    _availability[_name] = True


def uses_fallback(scheme: int) -> bool:
    """Whether this scheme code is served by the pure-python fallback."""
    return _FALLBACK.get(_SCHEME_LIBS[int(scheme)], False)


_SCHEME_NAMES = {
    0: "zlib", 1: "zstandard", 2: "lz4", 3: "snappy", 4: "bzip", 5: "lzma",
    6: "blosc_zlib", 7: "blosc_zstd", 8: "blosc_lz4", 9: "blosc_snappy",
    10: "blosclz", 11: "blosc_lz4hc", 12: "tpu_rans",
}

_SCHEME_LIBS = {
    0: "zlib", 1: "zstandard", 2: "lz4", 3: "snappy", 4: "bz2", 5: "lzma",
    **{code: "blosc" for code in range(6, 12)}, 12: "zlib",  # rans: stdlib only
}

_BLOSC_CNAMES = {6: "zlib", 7: "zstd", 8: "lz4", 9: "snappy", 10: "blosclz", 11: "lz4hc"}


def scheme_name(scheme: int) -> str:
    return _SCHEME_NAMES[int(scheme)]


def is_available(scheme: int) -> bool:
    return _availability.get(_SCHEME_LIBS[int(scheme)], False)


def available_schemes() -> list:
    return [code for code in range(13) if is_available(code)]


@dataclass
class Codec:
    """A (compress, decompress) pair for one scheme code."""

    scheme: int
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


_warned_fallback: set = set()


def get_codec(scheme: int, level: int = 1) -> Codec:
    """Build a Codec for the given scheme code and compression level."""
    scheme = int(scheme)
    if not is_available(scheme):
        raise ImportError(
            f"For compression code {scheme} package {_SCHEME_LIBS[scheme]} is required."
        )
    if uses_fallback(scheme) and scheme not in _warned_fallback:
        _warned_fallback.add(scheme)
        import warnings

        warnings.warn(
            f"scheme {scheme} ({_SCHEME_NAMES[scheme]}): the "
            f"{_SCHEME_LIBS[scheme]} C library is not installed, using the "
            "pure-python fallback — format-conformant but ~1000x slower than "
            "the native codec; install the C binding for production use",
            RuntimeWarning, stacklevel=2)

    if scheme == 0:
        return Codec(0, "zlib", lambda d: zlib.compress(d, level), zlib.decompress)
    if scheme == 12:
        from .. import native as _native

        return Codec(12, "tpu_rans", _native.rans_compress,
                     _native.rans_decompress)
    if scheme == 1:
        cctx = _zstd.ZstdCompressor(level=level, write_content_size=False)
        dctx = _zstd.ZstdDecompressor()
        # frame sizes are stored in container metadata, not the zstd stream, so
        # decompression must be told a max output size
        return Codec(
            1, "zstandard",
            cctx.compress,
            lambda d: dctx.decompress(d, max_output_size=1 << 31),
        )
    if scheme == 2:
        if _lz4_frame is None:
            return Codec(2, "lz4-purepy",
                         lambda d: _purepy.lz4_frame_compress(d, level),
                         _purepy.lz4_frame_decompress)
        return Codec(
            2, "lz4",
            lambda d: _lz4_frame.compress(d, compression_level=level, store_size=False),
            _lz4_frame.decompress,
        )
    if scheme == 3:
        if _snappy is None:
            return Codec(3, "snappy-purepy", _purepy.snappy_compress,
                         _purepy.snappy_decompress)
        return Codec(3, "snappy", _snappy.compress, _snappy.decompress)
    if scheme == 4:
        return Codec(4, "bzip", lambda d: bz2.compress(d, compresslevel=max(level, 1)), bz2.decompress)
    if scheme == 5:
        return Codec(5, "lzma", lambda d: lzma.compress(d, preset=level), lzma.decompress)
    if scheme in _BLOSC_CNAMES:
        cname = _BLOSC_CNAMES[scheme]
        if _blosc is None:
            return Codec(scheme, _SCHEME_NAMES[scheme] + "-purepy",
                         lambda d: _purepy.blosc_compress(
                             d, cname=cname, clevel=level),
                         _purepy.blosc_decompress)
        return Codec(
            scheme, _SCHEME_NAMES[scheme],
            lambda d: _blosc.compress(d, clevel=level, cname=cname, shuffle=_blosc.BITSHUFFLE),
            lambda d: _blosc.decompress(d, as_bytearray=False),
        )
    raise NotImplementedError(f"compression scheme {scheme} not implemented")


# ----------------------------------------------------------------------------
# Reference-compatible functional API (recode_compressors.py:40-129)
# ----------------------------------------------------------------------------

def compress(compression_scheme: int, compression_level: int, data, compressor_context=None) -> bytes:
    """Compress one blob; signature-compatible with the reference."""
    if compression_scheme == 1 and compressor_context is not None:
        return compressor_context.compress(bytes(data))
    return get_codec(compression_scheme, compression_level).compress(bytes(data))


def de_compress(compression_scheme: int, compressed_data, decompressor_context=None) -> bytes:
    """Decompress one blob; signature-compatible with the reference."""
    if compression_scheme == 1 and decompressor_context is not None and hasattr(decompressor_context, "decompress"):
        try:
            return decompressor_context.decompress(compressed_data, max_output_size=1 << 31)
        except TypeError:
            return decompressor_context.decompress(compressed_data)
    return get_codec(compression_scheme).decompress(bytes(compressed_data))


def import_checks(header: dict) -> bool:
    """Raise ImportError if the scheme recorded in a header is unavailable."""
    scheme = int(header["compression_scheme"])
    if scheme not in _SCHEME_LIBS:
        # untrusted header byte: unknown codes fail clean, not KeyError
        raise ValueError(f"Unknown compression scheme code: {scheme}")
    if is_available(scheme):
        return True
    print(
        f"For compression code {scheme} package {_SCHEME_LIBS[scheme]} is required."
    )
    raise ImportError(_SCHEME_LIBS[scheme])


def make_compressor_context(scheme: int, level: int) -> Optional[object]:
    """Reusable compressor context for schemes that benefit from one (zstd)."""
    if int(scheme) == 1 and _zstd is not None:
        return _zstd.ZstdCompressor(level=level, write_content_size=False)
    return None


def make_decompressor_context(scheme: int) -> Optional[object]:
    if int(scheme) == 1 and _zstd is not None:
        return _zstd.ZstdDecompressor()
    return None
