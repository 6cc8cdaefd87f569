"""Pure-Python fallback codecs for scheme codes 2, 3 and 6-11.

The port's own copy of pyrecode_tpu/codecs/purepy.py: the port imports nothing of the
JAX package.

The reference reaches lz4/snappy/blosc through optional C bindings
(recode_compressors.py:7-37) and simply errors when they are absent.  These
fallbacks keep every scheme code *executable* in dependency-free
environments:

* **LZ4 frame** (scheme 2) — full block-format encoder (greedy 4-byte hash
  matcher) and decoder, wrapped in an RFC-conformant frame (xxh32 header
  checksum, independent blocks, no content size — matching the reference's
  ``store_size=False``).  Output is readable by the real lz4 library and
  vice versa.
* **Snappy** (scheme 3) — encoder emitting literal + 2-byte-offset copy
  elements, full decoder for all four element types.
* **Blosc v1** (schemes 6-11) — header-conformant *memcpy-mode* streams
  (flags bit 1) on the encode side, which any real blosc decodes.  The
  decoder additionally reads internally-compressed chunks written by a
  real c-blosc1: block starts table, per-block split streams, byte-shuffle
  and bit-shuffle filters, and the blosclz/zlib block codecs (lz4/snappy
  blocks through the fallback decoders above; zstd blocks when the
  zstandard package is present).

These are correctness/capability fallbacks, not performance paths: the
default TPU pipeline uses scheme 0 with the device/native deflate.
"""

from __future__ import annotations

import struct

# --------------------------------------------------------------------- xxh32

_PRIME1 = 2654435761
_PRIME2 = 2246822519
_PRIME3 = 3266489917
_PRIME4 = 668265263
_PRIME5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (needed for the LZ4 frame header checksum)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _PRIME1 + _PRIME2) & _M32
        v2 = (seed + _PRIME2) & _M32
        v3 = seed
        v4 = (seed - _PRIME1) & _M32
        while i <= n - 16:
            lanes = struct.unpack_from("<4I", data, i)
            v1 = (_rotl((v1 + lanes[0] * _PRIME2) & _M32, 13) * _PRIME1) & _M32
            v2 = (_rotl((v2 + lanes[1] * _PRIME2) & _M32, 13) * _PRIME1) & _M32
            v3 = (_rotl((v3 + lanes[2] * _PRIME2) & _M32, 13) * _PRIME1) & _M32
            v4 = (_rotl((v4 + lanes[3] * _PRIME2) & _M32, 13) * _PRIME1) & _M32
            i += 16
        acc = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        acc = (seed + _PRIME5) & _M32
    acc = (acc + n) & _M32
    while i <= n - 4:
        acc = (acc + struct.unpack_from("<I", data, i)[0] * _PRIME3) & _M32
        acc = (_rotl(acc, 17) * _PRIME4) & _M32
        i += 4
    while i < n:
        acc = (acc + data[i] * _PRIME5) & _M32
        acc = (_rotl(acc, 11) * _PRIME1) & _M32
        i += 1
    acc ^= acc >> 15
    acc = (acc * _PRIME2) & _M32
    acc ^= acc >> 13
    acc = (acc * _PRIME3) & _M32
    acc ^= acc >> 16
    return acc


# ----------------------------------------------------------------- LZ4 block


def _lz4_emit(out: bytearray, literals: bytes, offset: int, mlen: int) -> None:
    lit = len(literals)
    token = (min(lit, 15) << 4) | (min(mlen - 4, 15) if mlen else 0)
    out.append(token)
    if lit >= 15:
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out.extend(literals)
    if mlen:
        out.extend(struct.pack("<H", offset))
        if mlen - 4 >= 15:
            rest = mlen - 4 - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)


def lz4_compress_block(src: bytes) -> bytes:
    """LZ4 block format, greedy 4-byte hash matcher."""
    n = len(src)
    if n == 0:
        return b"\x00"  # empty literal run
    out = bytearray()
    table: dict = {}
    i = 0
    anchor = 0
    limit = n - 12  # spec: last match must start >= 12 bytes from block end
    while i <= limit:
        key = src[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if 0 <= j and i - j <= 0xFFFF and src[j:j + 4] == key:
            m, k = i + 4, j + 4
            maxm = n - 5  # spec: last 5 bytes are literals
            while m < maxm and src[m] == src[k]:
                m += 1
                k += 1
            _lz4_emit(out, src[anchor:i], i - j, m - i)
            anchor = i = m
        else:
            i += 1
    _lz4_emit(out, src[anchor:], 0, 0)
    return bytes(out)


def lz4_decompress_block(src: bytes, max_size: int = 1 << 31) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while src[i] == 255:
                lit += 255
                i += 1
            lit += src[i]
            i += 1
        out.extend(src[i:i + lit])
        i += lit
        if i >= n:
            break  # last sequence: literals only
        offset = struct.unpack_from("<H", src, i)[0]
        i += 2
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while src[i] == 255:
                mlen += 255
                i += 1
            mlen += src[i]
            i += 1
        start = len(out) - offset
        for k in range(mlen):  # may self-overlap: byte-by-byte
            out.append(out[start + k])
        if len(out) > max_size:
            raise ValueError("LZ4 output exceeds limit")
    return bytes(out)


def lz4_frame_compress(data: bytes, level: int = 1) -> bytes:
    """Minimal LZ4 frame: v1, independent blocks, no content size/checksum
    (the reference's ``store_size=False`` profile)."""
    del level
    flg = 0x60  # version 01, block independence
    bd = 0x70   # 4 MB max block size
    hdr = bytes([flg, bd])
    hc = (xxh32(hdr) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", 0x184D2204) + hdr + bytes([hc]))
    pos = 0
    while pos < len(data) or pos == 0:
        chunk = data[pos:pos + (4 << 20)]
        pos += len(chunk)
        comp = lz4_compress_block(chunk)
        if len(comp) < len(chunk):
            out.extend(struct.pack("<I", len(comp)))
            out.extend(comp)
        else:
            out.extend(struct.pack("<I", len(chunk) | 0x80000000))
            out.extend(chunk)
        if pos >= len(data):
            break
    out.extend(struct.pack("<I", 0))  # end mark
    return bytes(out)


def lz4_frame_decompress(data: bytes) -> bytes:
    magic = struct.unpack_from("<I", data, 0)[0]
    if magic != 0x184D2204:
        raise ValueError("not an LZ4 frame")
    flg = data[4]
    i = 6
    has_content_size = bool(flg & 0x08)
    has_content_checksum = bool(flg & 0x04)
    has_dict_id = bool(flg & 0x01)
    block_checksum = bool(flg & 0x10)
    if has_content_size:
        i += 8
    if has_dict_id:
        i += 4
    i += 1  # HC byte
    out = bytearray()
    while True:
        size = struct.unpack_from("<I", data, i)[0]
        i += 4
        if size == 0:
            break
        raw = bool(size & 0x80000000)
        size &= 0x7FFFFFFF
        blk = data[i:i + size]
        i += size
        if block_checksum:
            i += 4
        out.extend(blk if raw else lz4_decompress_block(blk))
    del has_content_checksum
    return bytes(out)


# -------------------------------------------------------------------- snappy


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def snappy_compress(src: bytes) -> bytes:
    n = len(src)
    out = bytearray(_uvarint(n))

    def emit_literal(lit: bytes) -> None:
        m = len(lit)
        while m > 0:
            take = min(m, 65536)
            if take <= 60:
                out.append((take - 1) << 2)
            elif take <= 256:
                out.append(60 << 2)
                out.append(take - 1)
            else:
                out.append(61 << 2)
                out.extend(struct.pack("<H", take - 1))
            out.extend(lit[:take])
            lit = lit[take:]
            m -= take

    table: dict = {}
    i = 0
    anchor = 0
    while i + 4 <= n:
        key = src[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if 0 <= j and i - j <= 0xFFFF and src[j:j + 4] == key:
            m, k = i + 4, j + 4
            while m < n and src[m] == src[k]:
                m += 1
                k += 1
            emit_literal(src[anchor:i])
            offset = i - j
            mlen = m - i
            while mlen > 0:
                take = min(mlen, 64)
                if mlen - take in (1, 2, 3) and take > 4:
                    take -= 4  # keep the tail emittable (copies need len>=4)
                out.append(((take - 1) << 2) | 2)  # copy, 2-byte offset
                out.extend(struct.pack("<H", offset))
                mlen -= take
            anchor = i = m
        else:
            i += 1
    emit_literal(src[anchor:])
    return bytes(out)


def snappy_decompress(src: bytes) -> bytes:
    total = 0
    shift = 0
    i = 0
    while True:
        b = src[i]
        i += 1
        total |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    n = len(src)
    while i < n:
        tag = src[i]
        i += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                nb = length - 60
                length = int.from_bytes(src[i:i + nb], "little") + 1
                i += nb
            out.extend(src[i:i + length])
            i += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | src[i]
            i += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = struct.unpack_from("<H", src, i)[0]
            i += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = struct.unpack_from("<I", src, i)[0]
            i += 4
        start = len(out) - offset
        for k in range(length):
            out.append(out[start + k])
    if len(out) != total:
        raise ValueError(f"snappy: expected {total} bytes, got {len(out)}")
    return bytes(out)


# --------------------------------------------------------------------- blosc

_BLOSC_CODEC_IDS = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2,
                    "zlib": 3, "zstd": 4}
_BLOSC_VERSION_FORMAT = 2
_BLOSC_MEMCPYED = 0x2


def _blosc_memcpy_stream(data: bytes, codec_id: int, typesize: int) -> bytes:
    """Header-conformant blosc v1 stream in memcpy mode (stored raw)."""
    n = len(data)
    flags = _BLOSC_MEMCPYED | (codec_id << 5)
    header = struct.pack("<BBBBIII", _BLOSC_VERSION_FORMAT, 1, flags,
                         typesize, n, n, n + 16)
    return header + data


def blosclz_compress_block(src: bytes) -> bytes:
    """Encode one block as a valid blosclz token stream (RLE-oriented).

    Emits the subset of the format every c-blosc1 blosclz decoder accepts:
    literal runs (<= 32 bytes per ctrl) and distance-1 matches covering
    byte runs — the dominant structure of bit-shuffled sparse detector
    streams (zero planes).  General hash matching is deliberately skipped:
    a pure-python hash chain is ~100x slower for a few percent extra ratio
    on these streams.  Never uses the 16-bit far-distance escape, so no
    encoder-side distance edge cases exist.
    """
    import numpy as np

    n = len(src)
    if n == 0:
        return b""
    arr = np.frombuffer(src, np.uint8)
    # run boundaries: starts[i] is the first index of run i
    change = np.flatnonzero(np.diff(arr)) + 1
    if change.size > n // 4:
        # incompressible by RLE: let the caller store the block raw
        return b"\xff" * (n + 1)
    starts = np.concatenate(([0], change, [n]))
    out = bytearray()

    def emit_literals(lo, hi):
        while lo < hi:
            take = min(32, hi - lo)
            out.append(take - 1)
            out.extend(src[lo:lo + take])
            lo += take

    i = 0
    nruns = starts.size - 1
    while i < nruns:
        lo, hi = int(starts[i]), int(starts[i + 1])
        run = hi - lo
        if run >= 4:
            # one literal (the run byte) + distance-1 match of run-1
            emit_literals(lo, lo + 1)
            rest = run - 1
            # split into match tokens, each >= 3 long
            while rest >= 3:
                m = min(rest, 8 + 255 * 4)   # arbitrary large cap
                if rest - m in (1, 2):
                    m -= 3 - (rest - m)
                if m <= 8:
                    out.append((m - 2) << 5)
                    out.append(0)
                else:
                    out.append(7 << 5)
                    rem = m - 9
                    while rem >= 255:
                        out.append(255)
                        rem -= 255
                    out.append(rem)
                    out.append(0)
                rest -= m
            if rest:
                emit_literals(hi - rest, hi)
        else:
            # short run: merge with following short runs into one literal
            j = i
            while j + 1 < nruns and int(starts[j + 2]) - int(starts[j + 1]) < 4:
                j += 1
            emit_literals(lo, int(starts[j + 1]))
            i = j
        i += 1
    return bytes(out)


def blosc_compress(data: bytes, cname: str = "zlib", typesize: int = 8,
                   clevel: int = 5) -> bytes:
    """Compressing blosc v1 encoder (pure python, real-blosc-readable).

    Mirrors the container layout c-blosc1 writes (16-byte header, absolute
    u32 block starts, per-block split streams with i32 sizes, csize ==
    neblock meaning stored-raw) and the reference's filter choice
    (BITSHUFFLE, recode_compressors.py:103-118).  Internal codec: zlib for
    cname="zlib", the purepy lz4/snappy block coders for those cnames, and
    the blosclz token coder otherwise (zstd has no dependency-free encoder
    here; a blosclz-coded stream is still a valid blosc stream that any
    real-blosc reader decodes regardless of the requested cname).  Falls
    back to memcpy mode when compression does not pay or the input is
    tiny, exactly like c-blosc.
    """
    n = len(data)
    req_codec = _BLOSC_CODEC_IDS[cname]
    if n < 128 or clevel == 0:       # c-blosc MIN_BUFFERSIZE behavior
        return _blosc_memcpy_stream(data, req_codec, typesize)
    if cname == "zlib":
        codec_id = 3
    elif cname in ("lz4", "lz4hc"):
        codec_id = 1
    elif cname == "snappy":
        codec_id = 2
    else:                            # blosclz, zstd -> blosclz tokens
        codec_id = 0

    # block size: 32 KB rounded down to a whole number of 8-element groups
    # (so the bitshuffle filter never straddles blocks); any value decodes,
    # c-blosc itself varies it with clevel/cache size
    elem8 = max(typesize, 1) * 8
    blocksize = (1 << 15) - ((1 << 15) % elem8) if elem8 <= (1 << 15) else elem8
    nblocks = -(-n // blocksize)
    split = _blosc_split(codec_id, typesize, blocksize)

    def pack_piece(piece: bytes) -> bytes:
        if codec_id == 3:
            import zlib

            return zlib.compress(piece, min(max(clevel, 1), 9))
        if codec_id == 1:
            return lz4_compress_block(piece)
        if codec_id == 2:
            return snappy_compress(piece)
        return blosclz_compress_block(piece)

    body = bytearray()
    bstarts = []
    base = 16 + 4 * nblocks
    for bi in range(nblocks):
        bstarts.append(base + len(body))
        bsize = min(blocksize, n - bi * blocksize)
        block = data[bi * blocksize: bi * blocksize + bsize]
        block = _bit_shuffle(block, max(typesize, 1))
        nsplits = typesize if (split and bsize == blocksize) else 1
        neblock = bsize // nsplits
        for si in range(nsplits):
            piece = block[si * neblock: (si + 1) * neblock]
            packed = pack_piece(piece)
            if len(packed) >= neblock:
                body += struct.pack("<i", neblock) + piece
            else:
                body += struct.pack("<i", len(packed)) + packed
        if len(body) + base >= n + 16:
            # compression is not paying: ship memcpy mode, like c-blosc
            return _blosc_memcpy_stream(data, req_codec, typesize)
    flags = _BLOSC_DOBITSHUFFLE | (codec_id << 5)
    header = struct.pack("<BBBBIII", _BLOSC_VERSION_FORMAT, 1, flags,
                         max(typesize, 1), n, blocksize, base + len(body))
    return header + struct.pack(f"<{nblocks}I", *bstarts) + bytes(body)


def blosclz_decompress(src: bytes, max_out: int) -> bytes:
    """Decode one blosclz stream (the FastLZ-derived token format used by
    every c-blosc1 release; blosclz 2.x changed only the encoder).

    Tokens: ctrl byte with top 3 bits = match-length code.  len_code 0 =
    literal run of ``(ctrl & 31) + 1`` bytes; otherwise a match of length
    ``len_code + 2`` (len_code 7: plus 255-terminated extension bytes) at
    distance ``((ctrl & 31) << 8) + low_byte + 1``; the escape
    low_byte == 255 with ctrl offset bits == 31 switches to a 16-bit
    far-distance field biased by MAX_DISTANCE+1 (8192).  The first ctrl
    byte is masked to a literal run.
    """
    out = bytearray()
    n = len(src)
    if n == 0:
        return b""
    i = 0
    ctrl = src[i] & 31
    i += 1
    first = True
    while True:
        if not first and ctrl >= 32:
            length = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if length == 6:  # len_code 7: extension bytes
                while True:
                    code = src[i]
                    i += 1
                    length += code
                    if code != 255:
                        break
            code = src[i]
            i += 1
            length += 3
            distance = ofs + code + 1
            if code == 255 and ofs == (31 << 8):
                distance = ((src[i] << 8) | src[i + 1]) + 8191 + 1
                i += 2
            start = len(out) - distance
            if start < 0:
                raise ValueError("blosclz: match before start of output")
            for k in range(length):  # overlapping copies are byte-serial
                out.append(out[start + k])
        else:
            run = (ctrl & 31) + 1
            if i + run > n:
                raise ValueError("blosclz: truncated literal run")
            out += src[i:i + run]
            i += run
        first = False
        if i >= n:
            break
        ctrl = src[i]
        i += 1
    if len(out) > max_out:
        raise ValueError("blosclz: output exceeds declared block size")
    return bytes(out)


def _byte_unshuffle(block: bytes, typesize: int) -> bytes:
    """Invert blosc's byte shuffle: data was stored as typesize planes of
    n-th bytes; trailing ``len % typesize`` bytes are kept verbatim."""
    import numpy as np

    n = len(block) // typesize * typesize
    planes = np.frombuffer(block[:n], np.uint8).reshape(typesize, n // typesize)
    return planes.T.tobytes() + block[n:]


def _bit_unshuffle(block: bytes, typesize: int) -> bytes:
    """Invert blosc's bitshuffle filter (numpy bit transpose).

    Forward semantics (bitshuffle's own numpy reference model,
    bshuf_trans_bit_elem): view the first ``n8`` elements (n8 = elements
    rounded down to a multiple of 8) as an (n8, typesize*8) bit matrix in
    numpy's default big-endian bit order and transpose it; remaining bytes
    are copied through unshuffled (c-blosc's wrapper semantics for partial
    blocks).
    """
    import numpy as np

    elems = len(block) // typesize
    n8 = elems - elems % 8
    nb = n8 * typesize
    if n8 == 0:
        return block
    bits = np.unpackbits(np.frombuffer(block[:nb], np.uint8))
    bits = bits.reshape(typesize * 8, n8).T
    return np.packbits(bits.reshape(-1)).tobytes() + block[nb:]


def _bit_shuffle(block: bytes, typesize: int) -> bytes:
    """Forward bitshuffle (test twin of :func:`_bit_unshuffle`)."""
    import numpy as np

    elems = len(block) // typesize
    n8 = elems - elems % 8
    nb = n8 * typesize
    if n8 == 0:
        return block
    bits = np.unpackbits(np.frombuffer(block[:nb], np.uint8))
    bits = bits.reshape(n8, typesize * 8).T
    return np.packbits(bits.reshape(-1)).tobytes() + block[nb:]


_BLOSC_DOSHUFFLE = 0x1
_BLOSC_DOBITSHUFFLE = 0x4


def _blosc_block_decompress(codec_id: int, payload: bytes, neblock: int) -> bytes:
    if codec_id == 0:
        return blosclz_decompress(payload, neblock)
    if codec_id == 3:
        import zlib

        return zlib.decompress(payload)
    if codec_id == 1:
        return lz4_decompress_block(payload, neblock)
    if codec_id == 2:
        return snappy_decompress(payload)
    if codec_id == 4:
        try:
            import zstandard
        except ImportError as exc:  # pragma: no cover - environment dependent
            raise NotImplementedError(
                "blosc+zstd stream needs the zstandard package") from exc
        return zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=neblock)
    raise NotImplementedError(f"unknown blosc internal codec id {codec_id}")


def _blosc_split(codec_id: int, typesize: int, blocksize: int) -> bool:
    """c-blosc1's split_block rule: fast codecs (blosclz, lz4) split each
    block into ``typesize`` streams when typesize <= 16 (MAX_STREAMS) and
    blocksize/typesize >= 128 (MIN_BUFFERSIZE)."""
    return codec_id in (0, 1) and 1 < typesize <= 16 and \
        blocksize // typesize >= 128


def blosc_decompress(data: bytes) -> bytes:
    if len(data) < 16:
        raise ValueError("truncated blosc stream")
    _, _, flags, typesize, nbytes, blocksize, cbytes = \
        struct.unpack_from("<BBBBIII", data, 0)
    if flags & _BLOSC_MEMCPYED:
        if cbytes != nbytes + 16:
            raise ValueError("inconsistent blosc memcpy stream")
        return bytes(data[16:16 + nbytes])
    if nbytes == 0:
        return b""
    codec_id = (flags >> 5) & 7
    typesize = max(typesize, 1)
    nblocks = -(-nbytes // blocksize)
    bstarts = struct.unpack_from(f"<{nblocks}I", data, 16)
    out = bytearray()
    for bi in range(nblocks):
        bsize = min(blocksize, nbytes - bi * blocksize)
        pos = bstarts[bi]
        # c-blosc never splits the leftover (short) block
        nsplits = typesize if (_blosc_split(codec_id, typesize, blocksize)
                               and bsize == blocksize) else 1
        neblock = bsize // nsplits
        block = bytearray()
        for _ in range(nsplits):
            (csize,) = struct.unpack_from("<i", data, pos)
            pos += 4
            payload = bytes(data[pos:pos + csize])
            pos += csize
            if csize == neblock:  # stored raw
                piece = payload
            else:
                piece = _blosc_block_decompress(codec_id, payload, neblock)
            if len(piece) != neblock:
                raise ValueError(
                    f"blosc block {bi}: split decoded to {len(piece)} bytes, "
                    f"expected {neblock}")
            block += piece
        if flags & _BLOSC_DOBITSHUFFLE:
            block = bytearray(_bit_unshuffle(bytes(block), typesize))
        elif flags & _BLOSC_DOSHUFFLE:
            block = bytearray(_byte_unshuffle(bytes(block), typesize))
        out += block
    if len(out) != nbytes:
        raise ValueError(f"blosc: expected {nbytes} bytes, got {len(out)}")
    return bytes(out)
