"""The benchmark's plain scheme-12 decoder (``portbench/entropy/scheme12.py``)
against the streams it has to read.

It decodes to the input bytes every mode the port writes: the host coders'
symbol mode at 12 and 8 bits, gap mode, byte mode and stored blocks; the
device batch encoders run on CPU tensors (their twins), with the streams
they hand to the host coder; the byte-mode batch encoder; and the JAX
package's host coders on the same inputs.  A flipped body bit or a wrong
adler32 raises or decodes wrong.  A scheme-12 L1 container written by the
port with its device coders reads back through the benchmark's plain
reader.  The decoder imports neither package, nor JAX, nor torch.
"""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu.codecs import rans as jrans
from pyrecode_tpu_torch import oracle
from pyrecode_tpu_torch.codecs import rans as trans

REPO = Path(__file__).resolve().parents[1]
PLAIN = REPO / "portbench" / "entropy" / "scheme12.py"
RNG = np.random.default_rng(24)


def _load_plain():
    spec = importlib.util.spec_from_file_location("plain_scheme12", PLAIN)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


plain = _load_plain()


def _values(n, scale=10.0, top=4095):
    return np.minimum(RNG.exponential(scale, n), top).astype(np.uint64)


def _bitmap(n_bytes, p):
    return np.packbits(RNG.random(8 * n_bytes) < p, bitorder="little").tobytes()


def _two_gap_bitmap(n_bytes):
    """Set bits 4 or 41 apart: the gap transform codes a bit a set bit, far
    below what the bitmap's bytes as symbols take."""
    at = np.cumsum(RNG.choice([4, 41], n_bytes)) - 1
    bits = np.zeros(8 * n_bytes, np.uint8)
    bits[at[at < bits.size]] = 1
    return np.packbits(bits, bitorder="little").tobytes()


PAYLOADS = {
    "values12": oracle.bit_pack(_values(3000), 12).tobytes(),
    "values8": np.minimum(RNG.exponential(6, 5000), 255).astype(np.uint8).tobytes(),
    "bitmap": _two_gap_bitmap(100_000),
    "runs": np.repeat(RNG.integers(0, 3, 400, dtype=np.uint8),
                      RNG.integers(1, 60, 400)).tobytes(),
    "random": RNG.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
    "empty": b"",
}
# (payload, coder, flags the port's coder writes): symbol mode 2, gap mode 6,
# byte mode 0, stored 1
HOST_CASES = [
    ("values12", lambda m, d: m.compress_symbols(d, 12), 2),
    ("values8", lambda m, d: m.compress_symbols(d, 8), 2),
    ("bitmap", lambda m, d: m.compress_gaps(d), 6),
    ("runs", lambda m, d: m.compress(d), 0),
    ("random", lambda m, d: m.compress(d), 1),
    ("empty", lambda m, d: m.compress(d), 1),
]


@pytest.mark.parametrize("payload, coder, flags", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_host_coders(payload, coder, flags):
    data = PAYLOADS[payload]
    stream = coder(trans, data)
    assert stream[3] == flags
    assert plain.decompress(stream) == data
    assert plain.decompress(coder(jrans, data)) == data


def _device_inputs():
    """Two 1024^2 bitmaps at 8% (gap mode on the card), a short one (the host
    coder); 12-bit values of 70,000 and 2,000 pixels; 8-bit symbols of
    80,000 bytes; uniform 12-bit values, which the stored block beats."""
    bitmaps = np.stack([np.frombuffer(_bitmap(1 << 17, 0.08), np.uint8) for _ in range(3)])
    blens = np.array([1 << 17, 1 << 17, 4000])
    bitmaps[2, 4000:] = 0
    counts = np.array([70_000, 2_000, 70_000])
    vals = [_values(counts[0]), _values(counts[1]), RNG.integers(0, 4096, counts[2])]
    plens = (counts * 12 + 7) // 8
    packed = np.zeros((3, int(plens.max())), np.uint8)
    for i, v in enumerate(vals):
        packed[i, :plens[i]] = oracle.bit_pack(np.asarray(v, np.uint64), 12)
    bytes8 = np.minimum(RNG.exponential(6, (1, 80_000)), 255).astype(np.uint8)
    return bitmaps, blens, packed, plens, bytes8


DEVICE = _device_inputs()


def _lanes_and_flags(stream):
    return 1 << stream[2], stream[3]


def test_device_gap_encoder():
    bitmaps, blens, *_ = DEVICE
    streams = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps), blens)
    assert [_lanes_and_flags(s) for s in streams[:2]] == [(1024, 6)] * 2
    assert _lanes_and_flags(streams[2])[0] < 1024          # the host coder
    for stream, bitmap, n in zip(streams, bitmaps, blens):
        assert plain.decompress(stream) == bitmap[:n].tobytes()


def test_device_symbol_encoder():
    _, _, packed, plens, bytes8 = DEVICE
    streams = trans.rans_symbols_batch_device(torch.from_numpy(packed), plens, 12)
    assert _lanes_and_flags(streams[0]) == (1024, 2)
    assert _lanes_and_flags(streams[1])[0] < 1024           # the host coder
    assert streams[2][3] == 1                                # stored beats uniform values
    for stream, row, n in zip(streams, packed, plens):
        assert plain.decompress(stream) == row[:n].tobytes()
    [stream] = trans.rans_symbols_batch_device(torch.from_numpy(bytes8), [bytes8.shape[1]], 8)
    assert _lanes_and_flags(stream) == (1024, 2) and stream[24 - 4] == 8
    assert plain.decompress(stream) == bytes8.tobytes()


def test_device_byte_encoder():
    data = np.frombuffer(PAYLOADS["runs"] * 40, np.uint8)
    [stream] = trans.rans_batch_device(torch.from_numpy(data.copy())[None], [data.size])
    assert _lanes_and_flags(stream) == (1024, 0)
    assert plain.decompress(stream) == data.tobytes()


def _body_at(stream):
    """(start, length) of a coded stream's rANS body."""
    lanes, flags = _lanes_and_flags(stream)
    body = int.from_bytes(stream[12:16], "little")
    if flags & 2:
        used = int.from_bytes(stream[22:24], "little")
        return 24 + 4 * used + 4 * lanes, body
    used = int(np.unpackbits(np.frombuffer(stream[20:56], np.uint8)).sum())
    return 56 + 2 * used + 4 * lanes, body


def _corrupt_cases():
    bitmaps, blens, packed, plens, _ = DEVICE
    gaps = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps[:1]), blens[:1])[0]
    values = trans.rans_symbols_batch_device(torch.from_numpy(packed[:1]), plens[:1], 12)[0]
    return {"gaps": (gaps, bitmaps[0].tobytes()),
            "values": (values, packed[0, :plens[0]].tobytes()),
            "bytes": (trans.compress(PAYLOADS["runs"]), PAYLOADS["runs"]),
            "stored": (trans.compress(PAYLOADS["random"]), PAYLOADS["random"])}


CORRUPT = _corrupt_cases()


def _decodes_wrong_or_raises(stream, original):
    try:
        return plain.decompress(stream) != original
    except ValueError:
        return True


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_a_flipped_body_bit_or_a_wrong_adler_is_caught(name):
    stream, original = CORRUPT[name]
    assert plain.decompress(stream) == original
    if stream[3] & 1:
        start, length = 20, int.from_bytes(stream[4:8], "little")
    else:
        start, length = _body_at(stream)
    for at in (start, start + length // 2, start + length - 1):
        for bit in (0, 5):
            flipped = bytearray(stream)
            flipped[at] ^= 1 << bit
            assert _decodes_wrong_or_raises(bytes(flipped), original), (at, bit)
    wrong = bytearray(stream)
    wrong[-1] ^= 1
    with pytest.raises(ValueError):
        plain.decompress(bytes(wrong))


def test_format_faults_raise():
    stream, _ = CORRUPT["gaps"]
    lanes, _ = _lanes_and_flags(stream)
    states_at = _body_at(stream)[0] - 4 * lanes
    faults = {
        "magic": (0, 0x5A), "version": (1, 2), "flags": (3, 6 | 8),
        "a lane state": (states_at + 3, 0x00),    # below 2^23
        "truncated": None, "trailing": None,
    }
    for name, fault in faults.items():
        bad = bytearray(stream)
        if name == "truncated":
            bad = bad[:-5]
        elif name == "trailing":
            bad += b"\x00"
        else:
            bad[fault[0]] = fault[1]
        with pytest.raises(ValueError):
            plain.decompress(bytes(bad))


def test_imports_nothing_of_either_package():
    tree = ast.parse(PLAIN.read_text())
    names = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "zlib", "numpy"}, names
    script = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('s12', {str(PLAIN)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "data = bytes(range(256)) * 4\n"
        "assert m.decompress(bytes.fromhex(sys.argv[1])) == data\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    stream = trans.compress(bytes(range(256)) * 4)
    out = subprocess.run([sys.executable, "-c", script, stream.hex()], capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "pyrecode_tpu", "pyrecode_tpu_torch", "torch"}


SHAPE = (2, 1024, 1024)
EPSILON = 2


def _l1_frames():
    """Two 1024^2 frames at ~7% foreground: the writer codes their bitmaps as
    gaps from the encode's positions and their values as 12-bit symbols."""
    rng = np.random.default_rng(25)
    dark = rng.integers(0, 30, SHAPE[1:]).astype(np.uint16)
    data = (dark + rng.integers(0, EPSILON + 1, SHAPE)).astype(np.uint16)
    fg = rng.random(SHAPE) < 0.07
    base = np.broadcast_to(dark, SHAPE)[fg].astype(np.int64)
    data[fg] = np.minimum(base + EPSILON + 1 + rng.exponential(20.0, int(fg.sum())), 4095)
    return data, dark


def write_l1_scheme12(out_dir):
    """A merged scheme-12 L1 container of ``_l1_frames`` from the port's
    writer with its device coders (their twins on the CPU), in one batch
    with no padding frame; returns (path, frames, dark)."""
    from test_torch_slice import _params

    data, dark = _l1_frames()
    out_dir.mkdir(parents=True, exist_ok=True)
    w = port.ReCoDeWriter("test_data", dark_data=dark, output_directory=str(out_dir),
                          input_params=_params(shape=SHAPE, num_threads=1, compression_scheme=12,
                                               calibration_threshold_epsilon=EPSILON),
                          mode="batch", node_id=0, buffer_size_in_frames=SHAPE[0],
                          device="cpu", device_entropy=True)
    w.start()
    w.run(data)
    w.close()
    return port.merge_parts(str(out_dir), "test_data.rc1", 1), data, dark


def test_plain_reader_reads_the_device_coded_container(tmp_path):
    sys.path.insert(0, str(REPO))
    from portbench.plain_reader import PlainContainer

    merged, data, dark = write_l1_scheme12(tmp_path)
    container = PlainContainer(merged)
    assert container.nz == SHAPE[0]
    thr = dark.astype(np.int64) + EPSILON
    for z in range(SHAPE[0]):
        start = container.offsets[z]
        bm = Path(merged).read_bytes()[start:start + container.meta[z][0]]
        assert _lanes_and_flags(bm) == (1024, 6)
        want = np.where(data[z] > thr, data[z] - thr, 0)
        np.testing.assert_array_equal(container.dense(z), want)
