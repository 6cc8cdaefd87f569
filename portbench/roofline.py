"""A kernel's share of its roofline: the least time the chip could take
over the device time the trace gives the kernel's operations.

Every kernel here moves bytes and does little arithmetic, so the least time
is the bytes the call needs (each input read once, each output written
once, scratch not counted) over the card's memory bandwidth, from
``peaks.json`` by the card's name.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bitmap_bytes(n_pixels: int) -> int:
    return (n_pixels + 7) // 8


def packed_bytes(count: int, bits: int) -> int:
    return (int(count) * bits + 7) // 8


def share_pct(run, ops, bytes_moved: float):
    """100 x least time / device time of ``ops``; None where the trace lacks
    any of them (the bytes count every one: a kernel renamed or fused away
    leaves the share silent, never higher) or the card is not in the table
    of peaks."""
    seconds = run.trace.op_seconds(ops)
    missing = [op for op in ops if op not in seconds]
    if missing:
        print(f"roofline: the trace holds no {missing}", file=sys.stderr)
        return None
    kind = run.device_kind
    if kind not in PEAKS:
        print(f"roofline: no peak bandwidth for {kind!r} in peaks.json", file=sys.stderr)
        return None
    return 100.0 * bytes_moved / PEAKS[kind]["hbm_bytes_per_s"] / sum(seconds.values())
