"""The multi-device path driven once, every step checked: the port's
counterpart of ``__graft_entry__.py:dryrun_multichip``, step for step.

Rehearse it on the CPU with a mesh of CPU devices (every kernel runs its
plain twin there):

    python -c "import torch; from pyrecode_tpu_torch.parallel import dryrun_multidevice; \\
               dryrun_multidevice(8, [torch.device('cpu')] * 8)"
"""

from __future__ import annotations

import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernel_launch_counts, native, oracle
from ..codecs import dyndeflate as dd
from ..codecs import rans
from ..ops import hopper_bitpack, hopper_decode, hopper_deflate, hopper_rans
from ..ops.encode import count_foreground, encode_frames_auto
from ..params import InputParams
from ..reader import ReCoDeReader, merge_parts
from ..writer import ReCoDeWriter
from .mesh import CodecMesh, Sharded, make_codec_mesh
from .multihost import (gather_ordered_blocks, make_encode_step, make_entropy_steps,
                        make_rans_steps, replicate_threshold)
from .shard_encode import encode_frames_sharded

ORACLE_FRAMES = (0, -1)   # the frames also checked against oracle.reduce_frame

def _expect(condition, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def _sync(mesh: CodecMesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _default_frames(n_data: int, n_space: int):
    """The JAX dryrun's fixture: 2 frames a data shard, 16 rows a space
    shard, 256 columns, ~15% foreground."""
    rng = np.random.default_rng(0)
    shape = (2 * n_data, 16 * n_space, 256)
    frames = (rng.integers(0, 4096, size=shape) - 3500).clip(0).astype(np.uint16)
    threshold = rng.integers(0, 16, size=shape[1:]).astype(np.uint16)
    return frames, threshold


def _max_values(frames, threshold, device) -> int:
    return max(int(count_foreground(torch.from_numpy(frames).to(device),
                                    torch.from_numpy(threshold).to(device)).max()), 2)


def _check_level(res, frames, threshold, device, level: int, max_values: int,
                 statistic: Optional[str] = None) -> None:
    """Every frame of a sharded result against the unsharded encode, and
    ORACLE_FRAMES against oracle.reduce_frame."""
    kw = {"l2_statistic": statistic or "max", "l4_scheme": statistic or "weighted_average"}
    ref = encode_frames_auto(torch.from_numpy(frames).to(device),
                             torch.from_numpy(threshold).to(device), level, 12, max_values, **kw)
    bitmap = res.bitmap.numpy()
    _expect(not res.overflow.numpy().any(), f"sharded L{level} overflow")
    _expect(np.array_equal(bitmap, ref.bitmap.cpu().numpy()),
            f"sharded L{level} bitmaps differ from the unsharded encode")
    if res.packed is not None:
        plens = res.packed_len.numpy()
        _expect(np.array_equal(plens, ref.packed_len.cpu().numpy()),
                f"sharded L{level} stream lengths differ from the unsharded encode")
        packed, ref_packed = res.packed.numpy(), ref.packed.cpu().numpy()
        _expect(all(np.array_equal(packed[i, :n], ref_packed[i, :n]) for i, n in enumerate(plens)),
                f"sharded L{level} streams differ from the unsharded encode")
    for z in ORACLE_FRAMES:
        enc = oracle.reduce_frame(frames[z], threshold, level, 12, **kw)
        _expect(bitmap[z].tobytes() == enc["packed_binary_map"],
                f"sharded L{level} bitmap of frame {z} differs from the oracle")
        if res.packed is not None:
            n = int(res.packed_len.numpy()[z])
            _expect(res.packed.numpy()[z, :n].tobytes() == enc["packed_pixvals"],
                    f"sharded L{level} stream of frame {z} differs from the oracle")


def _writer_tail(device) -> None:
    """Two per-node writers (the whole pipeline, with device and with host
    entropy) -> part files -> merge_parts -> reader: the merged containers
    byte-equal, every frame read back exact."""
    rng = np.random.default_rng(5)
    wdata = np.where(rng.random((4, 64, 64)) < 0.04,
                     np.random.default_rng(6).integers(1, 4096, (4, 64, 64)), 0).astype(np.uint16)
    params = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=64, num_rows=64, num_frames=4,
        frame_offset=0, num_calibration_frames=1, calibration_frame_offset=0,
        keep_part_files=1, num_threads=2, l2_statistics=0, l4_centroiding=0,
        compression_scheme=0, compression_level=1, source_file_type=0,
        source_header_length=0, keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0))
    _expect(params.validate(), "invalid writer parameters")
    with tempfile.TemporaryDirectory() as tdir:
        merged = {}
        for sub, device_entropy in (("dev", True), ("host", False)):
            out = Path(tdir) / sub
            out.mkdir()
            for node_id in (0, 1):
                w = ReCoDeWriter("dry", dark_data=np.zeros((64, 64), np.uint16),
                                 output_directory=str(out), input_params=params,
                                 node_id=node_id, device_entropy=device_entropy,
                                 fast_deflate=True, device=device)
                w.start()
                w.run(wdata)
                w.close()
            merged[sub] = Path(merge_parts(str(out), "dry.rc1", 2)).read_bytes()
        _expect(merged["dev"] == merged["host"], "merged container bytes differ")
        reader = ReCoDeReader(str(Path(tdir) / "dev" / "dry.rc1"), device=device)
        reader.open()
        for i in range(4):
            fd = reader.get_next_frame()
            _expect(np.array_equal(fd[i]["data"].todense(), wdata[i]),
                    f"merged frame {i} decode mismatch")
        reader.close()


def _entropy_and_rans(mesh1d: CodecMesh, raws: list, step) -> dict:
    """The sharded deflate and rANS steps on byte streams ``raws``, and
    rans_batch_device on the same streams, each run through ``step``;
    returns stream counts by kind."""
    n = len(raws)
    npad = -(-max(len(r) for r in raws) // hopper_deflate.TILE) * hopper_deflate.TILE
    streams = np.zeros((n, npad), np.uint8)
    for i, raw in enumerate(raws):
        streams[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    lengths = np.array([len(r) for r in raws], np.int32)

    # deflate: tokenize and assemble per shard, Huffman tables on the host
    tokenize, assemble = make_entropy_steps(mesh1d, 2 * npad + 256)

    def entropy():
        tok, hist, adler = tokenize(streams, lengths)
        hist_np, adler_np = hist.numpy(), adler.numpy()
        tables = dd.host_tables(hist_np)
        body, totbits, overflow = assemble(tok, tables.luts, tables.phases, tables.partials)
        _expect(not overflow.numpy().any(), "sharded entropy overflow")
        body_np, totbits_np = body.numpy(), totbits.numpy()
        deflated = []
        for i in range(n):
            hdr, hdr_bits = tables.headers[i]
            spliced, bits2 = dd.splice_eob(body_np[i], int(totbits_np[i]), *tables.eobs[i])
            deflated.append(dd.finish_stream(hdr, hdr_bits, spliced, bits2, int(adler_np[i]),
                                             len(raws[i]), raw=raws[i]))
        return tok, hist_np, deflated

    tok, hist_np, deflated = step("entropy steps", entropy)
    for i, stream in enumerate(deflated):
        _expect(stream == native.deflate_sparse(raws[i]),
                f"sharded entropy stream {i} != native.deflate_sparse")

    # rANS: compaction, then the token encode and the symbol decode per shard
    m = hist_np[:, :rans.N_SYM].sum(axis=1).astype(np.int32)
    tok_bound = rans.token_capacity(m)
    encode, decode = make_rans_steps(mesh1d, 2 * tok_bound + 16, tok_bound)

    def rans_steps():
        dense = Sharded([hopper_deflate.compact_tokens(t, tok_bound)[0] for t in tok])
        freq, cum = (a.astype(np.int32) for a in rans.freq_tables(hist_np, rans.N_SYM))
        rbody, rstates, rcounts = encode(dense, freq, cum, m)
        rb, rc = rbody.numpy(), rcounts.numpy()
        bodies_rev = np.zeros((n, max(int(rc.max()), 1)), np.uint8)
        for i in range(n):
            bodies_rev[i, :rc[i]] = rb[i, :rc[i]][::-1]
        tabs = np.stack([hopper_rans.decode_tables(f) for f in freq])
        return decode(bodies_rev, rc, rstates, m, tabs)

    syms, underflow = step("rans steps", rans_steps)
    syms_np = syms.numpy()
    _expect(not underflow.numpy().any(), "sharded rANS decode underflow")
    for i in range(n):
        lut_idx, _ = dd.tokenize_bytes_np(np.frombuffer(raws[i], np.uint8))
        ref_syms, _, _ = rans._token_syms_and_extras(lut_idx)
        _expect(np.array_equal(syms_np[i, :m[i]], ref_syms),
                f"sharded rANS decode stream {i} mismatch")

    # the byte-mode device coder on the same streams
    device = mesh1d.devices[0]
    coded = step("rans_batch_device", lambda: rans.rans_batch_device(
        torch.from_numpy(streams).to(device), lengths, raw_cb=lambda i: raws[i]))
    kinds = {}
    for i, (raw, stream) in enumerate(zip(raws, coded)):
        h = rans._parse_header(stream)
        kind = "stored" if "stored" in h else f"byte/{h['nways']} lanes"
        kinds[kind] = kinds.get(kind, 0) + 1
        if "stored" in h or m[i] >= rans.W_LANES:
            _expect(stream == native.rans_compress(raw, rans.W_LANES),
                    f"rans_batch_device stream {i} != native.rans_compress(raw, 1024)")
        _expect(rans.decompress(stream) == raw, f"rans_batch_device stream {i} decode mismatch")
    _expect(rans.rans_decompress_device_batch(coded, device) == raws,
            "rans_decompress_device_batch differs from the raw streams")
    return kinds


def dryrun_multidevice(n_devices: int, devices: Optional[Sequence] = None,
                       n_space: Optional[int] = None, data=None, puddles=None) -> dict:
    """Build an n-device ('data', 'space') mesh and run every step of the
    multi-device path once, each checked; raises AssertionError on a
    mismatch.

    ``devices`` defaults to the first ``n_devices`` CUDA devices; a device
    may repeat (``[torch.device("cpu")] * 8`` rehearses on the CPU).
    ``n_space`` defaults to 2 where n_devices is even, as the JAX dryrun.
    ``data`` (frames (B, H, W) uint16, threshold (H, W) uint16) defaults to
    the JAX dryrun's tiny fixture; ``puddles``, a pair of the same kind for
    L2 and L4, to ``data``.  Steps: sharded L1 (``shard_rows`` on a space
    axis wider than 1), L4 and L2 sum, each frame against the unsharded
    encode and the first and last against oracle.reduce_frame; the encode
    step on a 1-D mesh and the ordered gather; the sharded decode, bit-exact;
    the entropy steps on the gathered bitmaps (each stream equal to
    native.deflate_sparse), the rANS steps (decoded symbols equal to the
    host tokenizer's) and rans_batch_device on the same streams (equal to
    native.rans_compress at 1024 lanes, read back by rans.decompress and
    rans_decompress_device_batch); then two writers with device and host
    entropy, merged, equal and read back.  The deflate steps' Huffman
    tables need the native host library, as the scheme-0 device writer
    does: without it the dryrun raises RuntimeError.  Returns a report: the gathered
    blocks, the wall seconds of each step, the kinds of the
    rans_batch_device streams, and the kernel launches of the path's own
    steps (the sharded ones and rans_batch_device; not those of the
    references they are checked against, nor the writers').
    """
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multidevice({n_devices}) needs {n_devices} CUDA devices; "
                               "pass devices= for another mesh")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for n_devices={n_devices}")
    if n_space is None:
        n_space = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_codec_mesh(n_devices // n_space, n_space, devices)
    home = mesh.devices[0]
    frames, threshold = data if data is not None else _default_frames(mesh.n_data, n_space)
    pframes, pthreshold = puddles if puddles is not None else (frames, threshold)
    height, width = frames.shape[1:]
    walls, launches = {}, Counter()

    def step(name, fn):
        """Run one step of the path: its wall, and its kernel launches."""
        before = kernel_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        _sync(mesh)
        walls[name] = time.perf_counter() - t0
        launches.update({k: v - before[k] for k, v in kernel_launch_counts().items()})
        return out

    # sharded L1, rows over 'space' when it is wider than 1
    max_values = _max_values(frames, threshold, home)
    res = step("sharded L1", lambda: encode_frames_sharded(
        frames, threshold, mesh, 1, 12, max_values, shard_rows=n_space > 1))
    _check_level(res, frames, threshold, home, 1, max_values)

    # L4 (labels and centroids) and L2 sum (labels and per-puddle sums)
    p_values = _max_values(pframes, pthreshold, home)
    for level, statistic in ((4, "weighted_average"), (2, "sum")):
        kw = {"l4_scheme": statistic} if level == 4 else {"l2_statistic": statistic}
        res_l = step(f"sharded L{level}", lambda: encode_frames_sharded(
            pframes, pthreshold, mesh, level, 12, p_values, shard_rows=n_space > 1, **kw))
        _check_level(res_l, pframes, pthreshold, home, level, p_values, statistic)

    # the per-shard encode step over a 1-D mesh and the ordered gather
    mesh1d = make_codec_mesh(n_devices, 1, devices)
    frames1d = frames[:len(frames) - len(frames) % n_devices]
    encode = make_encode_step(mesh1d, out_size=max_values, bit_depth=12)
    bitmap, packed, counts, overflow = step("encode step", lambda: encode(
        frames1d, replicate_threshold(threshold, mesh1d)))
    _expect(not overflow.numpy().any(), "encode step overflow")
    blocks = gather_ordered_blocks(bitmap, packed, counts, bit_depth=12)
    ref = encode_frames_auto(torch.from_numpy(frames1d).to(home),
                             torch.from_numpy(threshold).to(home), 1, 12, max_values)
    ref_bm, ref_pk, ref_len = (t.cpu().numpy() for t in (ref.bitmap, ref.packed, ref.packed_len))
    for i, (bm, pk) in enumerate(blocks):
        _expect(bm == ref_bm[i].tobytes() and pk == ref_pk[i, :ref_len[i]].tobytes(),
                f"gathered block {i} differs from the unsharded encode")
    for z in ORACLE_FRAMES:
        enc = oracle.reduce_frame(frames1d[z], threshold, 1, 12)
        _expect(blocks[z] == (enc["packed_binary_map"], enc["packed_pixvals"]),
                f"gathered block of frame {z} differs from the oracle")

    # sharded decode of the gathered streams: unpack and decode per shard
    def decode(bm, pk):
        values = hopper_bitpack.bitunpack12(pk)
        return hopper_decode.decode_l1(bm, values, height, width)

    dense, dec_overflow = step("sharded decode", lambda: tuple(
        Sharded(list(col)) for col in zip(*(decode(bm, pk) for bm, pk in zip(bitmap, packed)))))
    expected = np.where(frames1d > threshold[None], frames1d - threshold[None], 0)
    _expect(not dec_overflow.numpy().any() and np.array_equal(
        dense.numpy(), expected),
        "sharded decode mismatch")

    kinds = _entropy_and_rans(mesh1d, [bm for bm, _ in blocks], step)
    t0 = time.perf_counter()
    _writer_tail(home)
    walls["writer tail"] = time.perf_counter() - t0
    return {"blocks": blocks, "walls": walls, "rans_batch_device": kinds,
            "launches": dict(launches), "mesh": mesh.shape}
