"""The scheme-12 path's spans (``profiling.annotate``): with no profile
recording, one flag check each (no ``record_function``, nothing in the
table); under a profile, ``rans.encode`` a batch-encoder call with its
children ``rans.code`` and ``rans.host_stage``, one of ``rans.assemble``
(child ``rans.stored``) or ``rans.host_coder`` a stream, and one of
``reader.rans_chain`` or ``reader.rans_bytes`` a scheme-12 L1 read, with
the same outputs as untraced."""

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import profiling
from pyrecode_tpu_torch.codecs import rans as trans
from test_torch_rans_plain import DEVICE, SHAPE, write_l1_scheme12
from test_torch_spans import _Refuse

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty_table():
    port.reset_span_totals()
    yield
    port.reset_span_totals()


def _counts():
    return {name: count for name, (count, _) in port.span_totals().items()}


def _encode_both():
    bitmaps, blens, packed, plens, _ = DEVICE
    return (trans.rans_gaps_batch_device(torch.from_numpy(bitmaps), blens),
            trans.rans_symbols_batch_device(torch.from_numpy(packed), plens, 12))


@pytest.fixture(scope="module")
def container(tmp_path_factory):
    return write_l1_scheme12(tmp_path_factory.mktemp("rans_spans"))


def _read(merged, verify=False):
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    try:
        return reader.read_frames_dense(0, SHAPE[0], verify=verify)
    finally:
        reader.close()


def test_off_enters_no_record_function_and_no_table(monkeypatch, container):
    monkeypatch.setattr(torch.profiler, "record_function", _Refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Refuse)
    monkeypatch.setattr(profiling, "_SPAN_LOCK", _Refuse.__new__(_Refuse))
    _encode_both()
    _read(container[0])
    _read(container[0], verify=True)
    monkeypatch.undo()
    assert port.span_totals() == {}


def test_encoder_spans():
    """Gaps: two streams coded on the card, one by the host coder.  Values:
    one coded on the card, one by the host coder, one coded on the card and
    then stored."""
    plain = _encode_both()
    with torch.profiler.profile(activities=CPU):
        traced = _encode_both()
    assert traced == plain
    counts = _counts()
    assert counts["rans.encode"] == 2
    assert (counts["rans.assemble"], counts["rans.stored"], counts["rans.host_coder"]) == (4, 1, 2)
    # a batch call: the device work before and after the quantisation, and
    # the gap symbols, the unpack and the adler32 sums
    assert counts["rans.code"] >= 2 * 2 and counts["rans.host_stage"] == 2 * 2
    totals = port.span_totals()
    assert totals["rans.encode"][1] >= totals["rans.code"][1] + totals["rans.host_stage"][1] - 1e-3


def test_positions_overflow_takes_the_host_coder_for_the_batch():
    bitmaps, blens, *_ = DEVICE
    with torch.profiler.profile(activities=CPU):
        streams = trans.rans_gaps_batch_device(torch.from_numpy(bitmaps), blens, out_bound=8192)
    assert _counts()["rans.host_coder"] == len(streams)
    assert "rans.assemble" not in _counts()
    assert streams == [trans.compress_gaps(b[:n].tobytes()) for b, n in zip(bitmaps, blens)]


def test_writer_codes_every_stream_on_the_card(tmp_path):
    with torch.profiler.profile(activities=CPU):
        write_l1_scheme12(tmp_path)
    counts = _counts()
    batches = counts["writer.entropy"]
    assert counts["rans.encode"] == 2 * batches          # the bitmaps' call, the values'
    assert counts["rans.assemble"] == 2 * SHAPE[0]
    assert "rans.host_coder" not in counts and "rans.stored" not in counts


@pytest.mark.parametrize("verify, span", [(False, "reader.rans_chain"),
                                          (True, "reader.rans_bytes")])
def test_reader_spans(container, verify, span):
    merged, *_ = container
    plain = _read(merged, verify)
    with torch.profiler.profile(activities=CPU):
        traced = _read(merged, verify)
    np.testing.assert_array_equal(traced, plain)
    counts = _counts()
    assert counts["reader.read_frames_dense"] == 1 and counts[span] == 1
    other = {"reader.rans_chain", "reader.rans_bytes"} - {span}
    assert not other & set(counts)
