"""The check catches the faults a cell can have: a run driven through the
harness, with the timed path broken underneath, comes out not correct;
in a write cell also every acquisition written as the first one was (a
cache across acquisitions).  The harness's look for a card is skipped (the program's plain twins run on
the CPU at a small size); the exchange between chips does not apply to
one-chip cells."""

import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import reader, writer
from portbench.tests.small import run_small

WRITE_CELLS = ["de16_l1_zlib.write", "de16_l4_centroid.write"]
FAULTS = ["answer_altered", "half_left_out", "state_unchanged"]


def _break_writer(monkeypatch, fault):
    if fault == "answer_altered":      # a value (L1) or a centroid bit (L4) where it is made
        encode = writer.encode_frames_auto

        def altered(*args, **kwargs):
            res = encode(*args, **kwargs)
            (res.packed if res.packed is not None else res.bitmap)[:, 0] ^= 1
            return res
        monkeypatch.setattr(writer, "encode_frames_auto", altered)
    elif fault == "half_left_out":     # half of each batch's frames never written
        finish = writer.ReCoDeWriter._finish_batch

        def half(self, batch, first, dispatched, n_in_batch, metrics):
            return finish(self, batch, first, dispatched, max(n_in_batch // 2, 1), metrics)
        monkeypatch.setattr(writer.ReCoDeWriter, "_finish_batch", half)
    elif fault == "acquisition_reused":  # every acquisition written as the first one was
        run, first = port.ReCoDeServer.run, {}

        def reused(self, *args, data=None, **kwargs):
            return run(self, *args, data=first.setdefault("data", data), **kwargs)
        monkeypatch.setattr(port.ReCoDeServer, "run", reused)
    else:                              # every batch encodes as the node's first did
        dispatch = writer.ReCoDeWriter._dispatch_encode

        def stale(self, batch):
            if not hasattr(self, "_first_dispatch"):
                self._first_dispatch = dispatch(self, batch)
            return self._first_dispatch
        monkeypatch.setattr(writer.ReCoDeWriter, "_dispatch_encode", stale)


def _break_reader(monkeypatch, fault):
    if fault == "state_unchanged":     # every call returns what the first returned
        read = port.ReCoDeReader.read_frames_dense

        def stale(self, start, count, **kwargs):
            if not hasattr(self, "_first_read"):
                self._first_read = read(self, start, count, **kwargs)
            return self._first_read
        monkeypatch.setattr(port.ReCoDeReader, "read_frames_dense", stale)
        return
    decode = reader.decode_l1

    def broken(*args):
        dense, overflow = decode(*args)
        dense = dense.clone()
        if fault == "answer_altered":  # one pixel of each frame altered
            dense.view(torch.int16).reshape(dense.shape[0], -1)[:, 0] ^= 1
        else:                          # the second half of the batch left out
            dense[dense.shape[0] // 2:] = 0
        return dense, overflow
    monkeypatch.setattr(reader, "decode_l1", broken)


@pytest.mark.parametrize("fault", FAULTS + ["acquisition_reused"])
@pytest.mark.parametrize("name", WRITE_CELLS)
def test_write_fault_is_not_correct(monkeypatch, name, fault):
    _break_writer(monkeypatch, fault)
    result = run_small(name, frames=24)
    assert result["attempted"] >= 1
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_read_fault_is_not_correct(monkeypatch, fault):
    _break_reader(monkeypatch, fault)
    result = run_small("de16_l1_zlib.read", frames=24)
    assert result["attempted"] >= 1
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", WRITE_CELLS + ["de16_l1_zlib.read"])
def test_sound_run_is_correct(name):
    # a window long enough for the read check's four calls on a busy CPU
    result = run_small(name, seconds=2.0, frames=24)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert set(result["metrics"]) >= {"setup_s"}
