"""The port's device entropy stage (scheme-0 dynamic deflate) on the CPU.

The tokenize and assemble twins of ``pyrecode_tpu_torch.ops.hopper_deflate``
against the JAX package's Pallas kernels (interpret mode) and its numpy
oracles, the port's ``deflate_batch_device`` against ``native.deflate_sparse``
and the JAX ``deflate_batch_device``, and the port's writer with
``device_entropy=True`` against the JAX writer's part files.  Every
comparison is exact.
"""

import filecmp
import zlib

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu import InputParams, native
from pyrecode_tpu.codecs import dyndeflate as jdd
from pyrecode_tpu.ops import pallas_deflate as pdk
from pyrecode_tpu.reader import merge_parts
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch.codecs import dyndeflate as tdd
from pyrecode_tpu_torch.ops import hopper_deflate as hd
from chip_smoke import assemble_battery

T = hd.TILE          # the port's tile: bytes per tokenize block, tokens per assemble block
TA = pdk.CH_A        # the TPU tokenize kernel's grid step
NPAD = 2 * TA


def _battery():
    """Runs across the port's and the TPU's tiles, across the port's 522-byte
    run-end halo, at every take boundary of the C tokenizer, and the
    stored, literal-dense and empty cases."""
    rng = np.random.default_rng(7)
    streams = [
        b"",
        b"\x00" * T,                                # run == one port tile
        b"\x00" * (T + 1),                          # run crosses a port tile edge
        b"\x00" * (3 * T + 17),                     # run spans whole tiles
        b"X" * (T - 6) + b"\x00" * 5000 + b"Y",     # long run straddling port tiles
        b"X" * (TA - 6) + b"\x00" * 5000 + b"Y",    # ... and the TPU's
        b"A" + b"\x00" * 520 + b"B",
        b"\x07" * 261 + b"xy" + b"\x07" * 519,
        (rng.integers(0, 256, 9000) * (rng.random(9000) < 0.02)).astype(np.uint8).tobytes(),
        bytes(rng.integers(0, 256, 5000).astype(np.uint8)),    # stored fallback
        bytes(rng.integers(0, 3, 11000).astype(np.uint8)),     # dense tokens
    ]
    for off in (T - 2, T - 1, T, T + 1):
        streams.append(b"Q" * off + b"\x00" * 259 + b"R" * 40)
    for gap in (523, 524, 525, 526, 527):       # run end at the halo's last byte and past it
        streams.append(b"Z" * (T - 3) + b"\x00" * gap + b"W")
    return streams


BATTERY = _battery()


def _pack(raws, npad):
    streams = np.zeros((len(raws), npad), np.uint8)
    lengths = np.zeros(len(raws), np.int32)
    for i, r in enumerate(raws):
        streams[i, :len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    return streams, lengths


def _tokenize_both(raws, npad):
    streams, lengths = _pack(raws, npad)
    tok, hist, adler = pdk.tokenize_pallas(streams, lengths, interpret=True)
    ttok, thist, tadler = hd.tokenize(torch.from_numpy(streams), torch.from_numpy(lengths))
    return ((np.asarray(tok), np.asarray(hist), np.asarray(adler).astype(np.int64)),
            (ttok.numpy(), thist.numpy(), tadler.numpy()))


@pytest.fixture(scope="module")
def tokenized():
    return _tokenize_both(BATTERY, NPAD)


@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_tokenize_matches_jax_and_oracle(tokenized, i):
    (tok, hist, adler), (ttok, thist, tadler) = tokenized
    raw = BATTERY[i]
    assert np.array_equal(ttok[i], tok[i])
    assert np.array_equal(thist[i], hist[i])     # slot 287 included: covered and pad bytes
    assert int(tadler[i]) == int(adler[i]) == zlib.adler32(raw)
    ref_lut, ref_sym = jdd.tokenize_bytes_np(np.frombuffer(raw, np.uint8))
    assert np.array_equal(hd.NO_TOKEN - ttok[i, :len(raw)].astype(np.int32), ref_lut)
    ref_hist = jdd.histogram_np(ref_sym)
    ref_hist[256] -= 1                           # the kernels do not count end of block
    assert np.array_equal(thist[i, :286], ref_hist)


def test_tokenize_ignores_bytes_past_length():
    """Bytes past a stream's length are never read as data, whatever they hold."""
    rng = np.random.default_rng(2)
    streams = rng.integers(0, 4, (3, 3 * T + 5), dtype=np.uint8)
    lengths = np.array([0, T - 1, 2 * T + 600], np.int32)
    got = hd.tokenize(torch.from_numpy(streams), torch.from_numpy(lengths))
    clean = streams.copy()
    for row, n in enumerate(lengths):
        clean[row, n:] = 0
    want = hd.tokenize(torch.from_numpy(clean), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.uint16 else g,
                           w.view(torch.int16) if w.dtype == torch.uint16 else w)
    assert int(got[2][0]) == 1                   # adler32 of the empty stream


@pytest.fixture(scope="module")
def fused_inputs():
    rng = np.random.default_rng(31)
    raws = [
        (rng.integers(0, 256, NPAD) * (rng.random(NPAD) < 0.02)).astype(np.uint8).tobytes(),
        b"\x00" * 5000 + bytes(rng.integers(0, 256, 2048).astype(np.uint8)),
    ]
    return _pack(raws, NPAD)


@pytest.mark.parametrize("bucket", [0, 1])
def test_tokenize_compact_matches_jax(fused_inputs, bucket):
    streams, lengths = fused_inputs
    tok_bound = 2 * pdk.CH_B
    dense, hist, adler, counts, ovf = (np.asarray(a) for a in pdk.tokenize_compact_pallas(
        streams, lengths, bucket, tok_bound, interpret=True))
    tdense, thist, tadler, tcounts, tovf = (a.numpy() for a in hd.tokenize_compact(
        torch.from_numpy(streams), torch.from_numpy(lengths), tok_bound))
    assert np.array_equal(thist, hist)
    assert np.array_equal(tadler, adler.astype(np.int64))
    assert not tovf.any()
    assert np.array_equal(tcounts, thist[:, :286].sum(axis=1))
    for row in range(len(lengths)):
        if not ovf[row]:       # the TPU's capacity buckets may overflow; the port's bound does not
            assert np.array_equal(tdense[row], dense[row]), row
            assert tcounts[row] == counts[row]


def test_tokenize_compact_equals_two_pass(fused_inputs):
    """The fused form, with and without overflow, against tokenize + compact_tokens."""
    s, l = (torch.from_numpy(a) for a in fused_inputs)
    tok, hist, adler = hd.tokenize(s, l)
    n_tok = hist[:, :286].sum(dim=1)
    ref, ref_counts, ref_ovf = hd.compact_tokens(tok, 2 * T)
    assert torch.equal(ref_counts, n_tok.to(torch.int32)) and not ref_ovf.any()
    comp, hist2, adler2, counts, ovf = hd.tokenize_compact(s, l, 2 * T)
    assert torch.equal(comp, ref) and torch.equal(counts, ref_counts) and not ovf.any()
    assert torch.equal(hist2, hist) and torch.equal(adler2, adler)
    small = int(n_tok.min()) - 1
    comp, hist3, _, counts, ovf = hd.tokenize_compact(s, l, small)
    assert ovf.all() and torch.equal(counts, ref_counts) and torch.equal(hist3, hist)
    assert torch.equal(comp, ref[:, :small])      # the first out_bound tokens


def _assemble_inputs(raw):
    """Host tables for one stream, as deflate_batch_device builds them."""
    x = np.frombuffer(raw, np.uint8)
    lut_idx, sym = jdd.tokenize_bytes_np(x)
    llen, lcode = native.dyn_tables(jdd.histogram_np(sym))
    hb, hbits = native.dyn_header(llen)
    npad = -(-max(x.size, 1) // pdk.CH_B) * pdk.CH_B
    tok = np.zeros((1, npad), np.uint16)
    tok[0, :x.size] = (hd.NO_TOKEN - lut_idx).astype(np.uint16)
    return (tok, jdd.luts_as_radix(llen, lcode)[None], np.array([hbits % 8], np.int32),
            np.array([int(hb[-1]) if hbits % 8 else 0], np.int32), 2 * npad + 256, lut_idx,
            llen, lcode)


def _assemble_raws():
    rng = np.random.default_rng(11)
    sparse = (rng.integers(0, 256, 6000) * (rng.random(6000) < 0.02)).astype(np.uint8).tobytes()
    # ~10-bit literals filling whole 4096-token steps
    dense = (np.arange(20000, dtype=np.uint8) % 2).tobytes() + \
        (128 + np.arange(2 * T + 1024, dtype=np.uint8) % 128).tobytes()
    return {"sparse": sparse, "dense": dense, "one byte": b"\x05"}


@pytest.mark.parametrize("name", ["sparse", "dense", "one byte"])
def test_assemble_matches_jax_and_oracle(name):
    raw = _assemble_raws()[name]
    tok, lut, phase, partial, out_bound, lut_idx, llen, lcode = _assemble_inputs(raw)
    body, bits, ovf = pdk.assemble_pallas(tok, lut, phase, partial, out_bound,
                                          nw=pdk.WIN_ROWS_MAX, interpret=True)
    body, bits = np.asarray(body), int(np.asarray(bits)[0])
    args = [torch.from_numpy(a) for a in (lut, phase, partial)]
    u16 = torch.from_numpy(tok)
    i32 = torch.from_numpy(tok.astype(np.int32))
    for t in (u16, i32):
        tbody, tbits, tovf = hd.assemble(t, *args, out_bound)
        assert tbody.shape == body.shape
        assert int(tbits[0]) == bits and not bool(tovf[0]) and not bool(np.asarray(ovf)[0])
        assert np.array_equal(tbody[0, :(bits + 7) // 8].numpy(), body[0, :(bits + 7) // 8])
        assert not tbody[0, (bits + 7) // 8:].any()
    # the numpy oracle: the same tokens through assemble_bits_np
    val, nbits = jdd.token_luts(llen, lcode)
    keep = lut_idx != hd.NO_TOKEN
    ref, ref_bits = jdd.assemble_bits_np(val[lut_idx[keep]], nbits[lut_idx[keep]],
                                         int(phase[0]), int(partial[0]))
    assert ref_bits == bits and np.array_equal(tbody[0, :ref.size].numpy(), ref)


@pytest.fixture(scope="module")
def empty_tiles():
    """The assembler's edge battery case of 4 tiles a stream, phases 0..7:
    tiles of no tokens, a word holding bits of three tiles."""
    return next(c for c in assemble_battery(np.random.default_rng(27))
                if c[0] == "empty tiles")[1:]


@pytest.mark.parametrize("phase", range(8))
def test_assemble_empty_tiles_match_jax(empty_tiles, phase):
    """The plain version against the Pallas kernel (interpret mode) where
    tiles hold no token and a 32-bit word holds bits of three tiles, at each
    phase with its partial byte."""
    tok, lut, phases, partials = (a[phase:phase + 1] for a in empty_tiles)
    assert int(phases[0]) == phase
    u16 = tok.astype(np.uint16)
    out_bound = 2 * tok.shape[1] + 256
    body, bits, ovf = pdk.assemble_pallas(u16, lut, phases, partials, out_bound,
                                          nw=pdk.WIN_ROWS_MAX, interpret=True)
    body, bits = np.asarray(body), int(np.asarray(bits)[0])
    args = [torch.from_numpy(a) for a in (lut, phases, partials)]
    for t in (torch.from_numpy(u16), torch.from_numpy(tok)):
        tbody, tbits, tovf = hd.assemble(t, *args, out_bound)
        assert int(tbits[0]) == bits and not bool(tovf[0]) and not bool(np.asarray(ovf)[0])
        assert np.array_equal(tbody[0, :(bits + 7) // 8].numpy(), body[0, :(bits + 7) // 8])
        assert not tbody[0, (bits + 7) // 8:].any()


def test_assemble_overflow_and_bound():
    raw = _assemble_raws()["sparse"]
    tok, lut, phase, partial, _, *_ = _assemble_inputs(raw)
    args = [torch.from_numpy(a) for a in (tok, lut, phase, partial)]
    full, bits, ovf = hd.assemble(*args, 4096)
    assert not ovf[0] and full.shape == (1, 4096)
    cut, bits2, ovf2 = hd.assemble(*args, 100)      # rounded up to 128 bytes
    assert cut.shape == (1, 128) and bool(ovf2[0]) and int(bits2[0]) == int(bits[0])
    assert torch.equal(cut[0], full[0, :128])       # bytes past the bound are dropped


@pytest.fixture(scope="module")
def battery_deflated():
    streams, lengths = _pack(BATTERY, NPAD)
    jax_out = jdd.deflate_batch_device(streams, lengths, raw_cb=lambda i: BATTERY[i],
                                       interpret=True)
    port_out = tdd.deflate_batch_device(torch.from_numpy(streams), lengths)
    return jax_out, port_out


@pytest.mark.parametrize("i", range(len(BATTERY)))
def test_deflate_batch_matches_native_and_jax(battery_deflated, i):
    jax_out, port_out = battery_deflated
    assert port_out[i] == native.deflate_sparse(BATTERY[i]) == jax_out[i]
    assert zlib.decompress(port_out[i]) == BATTERY[i]


def _check_native(raws, outs):
    for i, (raw, got) in enumerate(zip(raws, outs)):
        assert got == native.deflate_sparse(raw), (i, len(raw))
        assert zlib.decompress(got) == raw, i


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(hd, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    monkeypatch.setattr(hd, name, spy)
    return calls


def test_deflate_fused_route_and_retry(monkeypatch):
    """A density hint runs the fused kernel; a hint far too low overflows its
    bound and is retried at the exact one; the bytes never change."""
    fused = _spy(monkeypatch, "tokenize_compact")
    dense = _spy(monkeypatch, "tokenize")
    rng = np.random.default_rng(77)
    hint = {}
    for density in (0.03, 0.03, 0.1):
        raws = [(rng.integers(0, 256, NPAD) * (rng.random(NPAD) < density))
                .astype(np.uint8).tobytes() for _ in range(3)]
        streams, lengths = _pack(raws, NPAD + 100)
        if density == 0.1:
            hint["density"] = 0.002
        _check_native(raws, tdd.deflate_batch_device(torch.from_numpy(streams), lengths,
                                                     hint_state=hint))
        assert 0 < hint["density"] < 0.5
    assert len(dense) == 1                       # only the first call, without a hint
    bounds = [args[2] for args in fused]
    assert len(bounds) == 3 and bounds[2] > bounds[1]   # the retry at the exact bound


def test_deflate_all_stored_batch_skips_assembly(monkeypatch):
    calls = _spy(monkeypatch, "assemble")
    rng = np.random.default_rng(99)
    raws = [bytes(rng.integers(0, 256, n).astype(np.uint8)) for n in (5000, T, 3 * T - 7)]
    streams, lengths = _pack(raws, 3 * T)
    _check_native(raws, tdd.deflate_batch_device(torch.from_numpy(streams), lengths,
                                                 raw_cb=lambda i: raws[i]))
    assert not calls


def test_deflate_literal_dense_sliced_route(monkeypatch):
    """Literal-dense streams assemble over a slice to the longest stream."""
    calls = _spy(monkeypatch, "assemble")
    rng = np.random.default_rng(17)
    raws = [bytes(rng.integers(0, 11, n).astype(np.uint8))
            for n in (3 * T - 5, 3 * T, 5 * T + 1, 11000)]
    streams, lengths = _pack(raws, 8 * T)
    _check_native(raws, tdd.deflate_batch_device(torch.from_numpy(streams), lengths))
    (tok, *_), = calls
    assert tok.dtype == torch.uint16 and tok.shape == (4, jdd.quantize_bound(5 * T + 1, T))


def _params(level=1, scheme=0, mode=1, n=(5, 64, 96)):
    p = InputParams(dict(
        reduction_level=level, rc_operation_mode=mode, calibration_threshold_epsilon=3,
        target_bit_depth=12, source_bit_depth=12, num_cols=n[2], num_rows=n[1],
        num_frames=n[0], frame_offset=0, num_calibration_frames=1, calibration_frame_offset=0,
        keep_part_files=1, num_threads=1, l2_statistics=0, l4_centroiding=0,
        compression_scheme=scheme, compression_level=1, source_file_type=0,
        source_header_length=0, keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0))
    assert p.validate()
    return p


def _frames(n=(5, 64, 96)):
    rng = np.random.default_rng(3)
    data = np.where(rng.random(n) < 0.04, rng.integers(40, 4096, n), 0).astype(np.uint16)
    dark = rng.integers(0, 30, n[1:]).astype(np.uint16)
    return data, dark


@pytest.mark.parametrize("level", [1, 3])
def test_writer_device_entropy_bytes_match_jax(tmp_path, level):
    """Part files with device entropy equal the JAX writer's (device entropy,
    interpret mode) and the port's host-entropy part files; the merged file
    reads back bit-exact."""
    data, dark = _frames()
    params = _params(level=level)
    parts = {}
    for name, cls, kwargs in (("jax", JaxWriter, {"device_entropy": True}),
                              ("port", port.ReCoDeWriter, {"device": "cpu",
                                                           "device_entropy": True}),
                              ("host", port.ReCoDeWriter, {"device": "cpu",
                                                           "device_entropy": False})):
        out = tmp_path / name
        out.mkdir()
        w = cls("v", dark_data=dark, output_directory=str(out), input_params=params,
                buffer_size_in_frames=2, **kwargs)
        assert w._device_entropy is kwargs["device_entropy"]
        w.start()
        w.run(data)
        w.close()
        parts[name] = out / f"v.rc{level}_part000"
    assert filecmp.cmp(parts["port"], parts["jax"], shallow=False)
    assert filecmp.cmp(parts["port"], parts["host"], shallow=False)
    merged = merge_parts(str(tmp_path / "port"), f"v.rc{level}", 1)
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    thr = dark.astype(np.int64) + 3
    fg = data > thr
    if level == 1:
        assert np.array_equal(reader.read_frames_dense(0, 5), np.where(fg, data - thr, 0))
    else:
        for z in range(5):
            assert np.array_equal(reader.get_frame(z)[z]["data"].toarray() > 0, fg[z])
    reader.close()


def test_writer_device_entropy_options(tmp_path):
    data, dark = _frames((2, 16, 16))

    def writer(params, **kwargs):
        return port.ReCoDeWriter("x", dark_data=dark, output_directory=str(tmp_path),
                                 input_params=params, device="cpu", **kwargs)

    assert writer(_params(n=(2, 16, 16)))._device_entropy is False   # auto: off on the CPU
    assert writer(_params(n=(2, 16, 16)), device_entropy=True)._device_entropy is True
    # scheme 12 codes on the device too (its rANS kernels' twins on the CPU)
    assert writer(_params(scheme=12, n=(2, 16, 16)), device_entropy=True)._device_entropy is True
    with pytest.raises(ValueError, match="rc_operation_mode 1"):
        writer(_params(mode=0, n=(2, 16, 16)), device_entropy=True)
    with pytest.raises(ValueError, match="compression_scheme 0"):
        writer(_params(scheme=4, n=(2, 16, 16)), device_entropy=True)
    assert writer(_params(scheme=12, n=(2, 16, 16)))._device_entropy is False
