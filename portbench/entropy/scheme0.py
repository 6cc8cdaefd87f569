"""Compression scheme 0: a zlib-format deflate stream (RFC 1950), checked
by its adler32."""

import zlib


def decompress(blob: bytes) -> bytes:
    return zlib.decompress(blob)
