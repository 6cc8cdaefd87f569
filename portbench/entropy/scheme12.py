"""Compression scheme 12: interleaved range-ANS (rANS), the port's own codec.

A plain decoder written from the stream format alone; it imports nothing of
the program.  Little-endian fields:

    u8 magic 0xA5, u8 version 1, u8 log2 of the lane count W, u8 flags
    u32 n (original bytes), u32 m (symbols), u32 body bytes, u32 extra-bits bytes

flags bit 0, stored: the n original bytes follow.  Otherwise, with bit 1
(symbol mode): u8 symbol width b (8..16), u8 pad, u16 k, k u16 symbols
ascending, k u16 frequencies; without it (byte mode): a 36-byte bitmap, LSB
first, of the used symbols of the 286-symbol alphabet, then one u16
frequency for each used symbol.  Then W u32 lane states, the body, the
extra bits (byte mode), and the adler32 of the n original bytes, big-endian.

The frequencies sum to M = 4096.  Symbol i belongs to lane i % W; the
decoder takes the symbols in rows of W, each lane of a row from its state x:
slot x mod M names the symbol s with cum[s] <= slot < cum[s] + freq[s], the
state becomes freq[s] (x >> 12) + slot - cum[s], and while it is below 2^23
it takes the next body byte, x = x << 8 | byte.  The body is read from its
end backward, a row's lanes in ascending order.  At the end every byte of
the body is taken and every lane is back at 2^23, where the encoder began.

What the symbols give:

* symbol mode, bit 2 clear: the original bytes are the m symbols packed
  LSB first at b bits each, cut or zero-padded to n bytes;
* gap mode, bits 1 and 2 (b is 12): an LSB-first bitmap of n bytes; symbol
  s < 4095 moves the cursor past s clear bits and sets the next one, 4095
  moves it past 4095 clear bits and sets none;
* byte mode: symbols 0..255 are literal bytes; 257 + c is a copy of the
  previous byte, LEN_BASE[c] + e times, e taken LSB first, LEN_EXTRA[c]
  bits, from the extra-bits stream in symbol order (DEFLATE's length codes,
  RFC 1951 3.2.5).

Any stream that breaks the format raises ``ValueError``.
"""

from __future__ import annotations

import zlib

import numpy as np

MAGIC, VERSION = 0xA5, 1
FIXED = 20                      # magic .. extra-bits bytes
M_BITS = 12
M = 1 << M_BITS
LOW = 1 << 23                   # the state's lower bound, and the encoder's start
BYTE_ALPHABET = 286
GAP_ESCAPE = 4095
LEN_BASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                     67, 83, 99, 115, 131, 163, 195, 227, 258], np.int64)
LEN_EXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
                      5, 5, 5, 5, 0], np.int64)


class _Cursor:
    """Reads fields off the stream, refusing to run past its end."""

    def __init__(self, blob: bytes, at: int):
        self.blob, self.at = blob, at

    def take(self, size: int) -> bytes:
        if size < 0 or self.at + size > len(self.blob):
            raise ValueError("the stream ends inside a field")
        out = self.blob[self.at:self.at + size]
        self.at += size
        return out

    def u(self, size: int) -> int:
        return int.from_bytes(self.take(size), "little")

    def u16s(self, count: int) -> np.ndarray:
        return np.frombuffer(self.take(2 * count), "<u2").astype(np.int64)


def decompress(blob: bytes) -> bytes:
    blob = bytes(blob)
    if len(blob) < FIXED:
        raise ValueError("shorter than the fixed header")
    if blob[0] != MAGIC or blob[1] != VERSION:
        raise ValueError(f"magic {blob[0]:#x}, version {blob[1]}")
    log2_lanes, flags = blob[2], blob[3]
    cur = _Cursor(blob, 4)
    n, m, body_bytes, xbits_bytes = (cur.u(4) for _ in range(4))
    if flags & ~0b111:
        raise ValueError(f"unknown flags {flags:#x}")
    if flags & 1:
        if flags != 1 or m or xbits_bytes or body_bytes != n:
            raise ValueError("a stored stream with coded fields")
        raw = cur.take(n)
    else:
        if log2_lanes > 16:
            raise ValueError(f"2^{log2_lanes} lanes")
        symbol_mode, gap = bool(flags & 2), bool(flags & 4)
        if gap and not symbol_mode:
            raise ValueError("gap mode without symbol mode")
        if symbol_mode:
            if xbits_bytes:
                raise ValueError("extra bits in symbol mode")
            width = cur.u(1)
            cur.take(1)
            if not 8 <= width <= 16 or (gap and width != 12):
                raise ValueError(f"symbols of {width} bits")
            used = cur.u16s(cur.u(2))
            if used.size == 0 or (np.diff(used) <= 0).any() or used[-1] >= 1 << width:
                raise ValueError("the used symbols are not ascending inside the alphabet")
            freq = np.zeros(1 << width, np.int64)
        else:
            bits = np.unpackbits(np.frombuffer(cur.take(36), np.uint8), bitorder="little")
            if bits[BYTE_ALPHABET:].any():
                raise ValueError("a used symbol past the byte-mode alphabet")
            used = np.flatnonzero(bits)
            freq = np.zeros(BYTE_ALPHABET, np.int64)
        freq[used] = cur.u16s(used.size)
        if freq.sum() != M or (freq[used] == 0).any():
            raise ValueError("the frequencies do not sum to 4096 over the used symbols")
        states = np.frombuffer(cur.take(4 << log2_lanes), "<u4").astype(np.int64)
        symbols = _rans_decode(cur.take(body_bytes), states, m, freq)
        if gap:
            raw = _gaps_to_bitmap(symbols, n)
        elif symbol_mode:
            raw = _pack(symbols, width, n)
        else:
            raw = _bytes_from_tokens(symbols, cur.take(xbits_bytes), n)
    adler = cur.take(4)
    if cur.at != len(blob):
        raise ValueError(f"{len(blob) - cur.at} bytes past the checksum")
    if zlib.adler32(raw) != int.from_bytes(adler, "big"):
        raise ValueError("adler32 mismatch")
    return raw


def _rans_decode(body: bytes, states: np.ndarray, m: int, freq: np.ndarray) -> np.ndarray:
    """The m symbols of an interleaved rANS body, the lanes of a row stepped
    together."""
    lanes = states.size
    if ((states < LOW) | (states >= 1 << 31)).any():
        raise ValueError("a lane state outside [2^23, 2^31)")
    cum = np.concatenate([[0], np.cumsum(freq)])
    symbol_of_slot = np.repeat(np.arange(freq.size), freq)
    stream = np.frombuffer(body, np.uint8)[::-1].astype(np.int64)
    x = states.copy()
    taken = 0
    out = np.empty(m, np.int64)
    for row in range(0, m, lanes):
        w = min(lanes, m - row)
        slot = x[:w] & (M - 1)
        s = symbol_of_slot[slot]
        out[row:row + w] = s
        y = freq[s] * (x[:w] >> M_BITS) + slot - cum[s]
        # y >= 2^11, so a lane takes one byte below 2^23 and two below 2^15;
        # each lane takes its bytes one after the other
        need = (y < LOW).astype(np.int64) + (y < LOW >> 8)
        k = int(need.sum())
        if taken + k > stream.size:
            raise ValueError("the body ends before the symbols do")
        at = taken + np.cumsum(need) - need
        for j in (0, 1):
            more = need > j
            y[more] = (y[more] << 8) | stream[at[more] + j]
        taken += k
        x[:w] = y
    if taken != stream.size:
        raise ValueError(f"{stream.size - taken} body bytes left after the last symbol")
    if (x != LOW).any():
        raise ValueError("a lane does not end at the encoder's starting state")
    return out


def _pack(symbols: np.ndarray, width: int, n: int) -> bytes:
    """The symbols packed LSB first at ``width`` bits, cut or padded to n bytes."""
    bits = ((symbols[:, None] >> np.arange(width)) & 1).astype(np.uint8).reshape(-1)
    raw = np.packbits(bits, bitorder="little").tobytes()[:n]
    return raw + bytes(n - len(raw))


def _gaps_to_bitmap(symbols: np.ndarray, n: int) -> bytes:
    bit = symbols != GAP_ESCAPE
    cursor = np.cumsum(np.where(bit, symbols + 1, GAP_ESCAPE))
    set_bits = cursor[bit] - 1
    if set_bits.size and set_bits[-1] >= 8 * n:
        raise ValueError("a set bit past the bitmap's end")
    flags = np.zeros(8 * n, np.uint8)
    flags[set_bits] = 1
    return np.packbits(flags, bitorder="little").tobytes()


def _bytes_from_tokens(symbols: np.ndarray, xbits: bytes, n: int) -> bytes:
    """Byte mode: literals and copies of the previous byte."""
    if (symbols == 256).any():
        raise ValueError("symbol 256 in byte mode")
    copy = symbols > 256
    code = np.where(copy, symbols - 257, 0)
    widths = np.where(copy, LEN_EXTRA[code], 0)
    stream = np.unpackbits(np.frombuffer(xbits, np.uint8), bitorder="little")
    if int(widths.sum()) > stream.size or (int(widths.sum()) + 7) // 8 != len(xbits):
        raise ValueError("the extra-bits stream does not match the symbols")
    starts = np.cumsum(widths) - widths
    extra = np.zeros(symbols.size, np.int64)
    for j in range(int(widths.max(initial=0))):
        has = widths > j
        extra[has] |= stream[starts[has] + j].astype(np.int64) << j
    takes = np.where(copy, LEN_BASE[code] + extra, 1)
    if int(takes.sum()) != n:
        raise ValueError(f"the symbols give {int(takes.sum())} bytes, the header {n}")
    if copy.size and copy[0]:
        raise ValueError("a copy before any literal")
    # a copy repeats the byte before it: the last literal at or before it
    last_literal = np.maximum.accumulate(np.where(copy, -1, np.arange(symbols.size)))
    return np.repeat(symbols[last_literal].astype(np.uint8), takes).tobytes()
