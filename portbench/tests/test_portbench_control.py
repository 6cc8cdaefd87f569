"""The control: the plain reference, one bit of precision below the
configuration's 12 bits (L1's residuals, L4's centroid weights lose their
lowest bit), put in the program's place and driven through the harness,
comes out not correct: at a small size on the CPU, at the cell's own size
on the card.

    python -m pytest -s -m gpu portbench/tests/test_portbench_control.py

prints one line a run on the card: the numbers the check compared.
"""

import json
import time

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from pyrecode_tpu_torch import writer
from portbench import frames, harness, reference, spec
from portbench.tests.small import SEED, small_cell

DROP_BITS = 1
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _emit_reference_on_write(monkeypatch):
    """The writer's encode hands on the reference's frames at DROP_BITS:
    at L1 it encodes frames whose residuals are the reference's (the
    program stores residuals exactly), at L4 its centroid bitmap is the
    reference's."""
    encode = writer.encode_frames_auto

    def control(data, threshold, level, *args, **kwargs):
        host, thr = data.cpu().numpy(), threshold.cpu().numpy()
        dense = np.stack([reference.expected(level, f, thr, DROP_BITS) for f in host])
        if level == 1:
            lowered = np.where(dense > 0, thr + dense, np.minimum(host, thr))
            return encode(torch.from_numpy(lowered).to(data.device), threshold, level,
                          *args, **kwargs)
        res = encode(data, threshold, level, *args, **kwargs)
        bits = np.packbits(dense.reshape(len(dense), -1) > 0, axis=1, bitorder="little")
        res.bitmap.zero_()
        res.bitmap[:, :bits.shape[1]] = torch.from_numpy(bits).to(res.bitmap.device)
        return res
    monkeypatch.setattr(writer, "encode_frames_auto", control)


def _emit_reference_on_read(monkeypatch, cell):
    """Every read call returns the reference's frames at DROP_BITS."""
    made = {}
    make = frames.make

    def keep(*args, **kwargs):
        out = make(*args, **kwargs)
        made["frames"], made["dark"] = out[0], out[1]
        return out

    params = cell.config["params"]
    level, eps = int(params["reduction_level"]), int(params["calibration_threshold_epsilon"])

    def control(self, start, count, **kwargs):
        thr = reference.threshold(made["dark"], eps)
        return np.stack([reference.expected(level, made["frames"][z], thr, DROP_BITS)
                         for z in range(start, start + count)])
    monkeypatch.setattr(frames, "make", keep)
    monkeypatch.setattr(port.ReCoDeReader, "read_frames_dense", control)


def _control_run(monkeypatch, cell, seed, device, seconds):
    if cell.traffic["pattern"] == "acquisitions":
        _emit_reference_on_write(monkeypatch)
    else:
        _emit_reference_on_read(monkeypatch, cell)
    return harness.execute(cell, seed, seconds, False, device, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(monkeypatch, name):
    result = _control_run(monkeypatch, small_cell(name, 256, 256, 24), SEED,
                          torch.device("cpu"), 0.3)
    assert not result["correct"], result["checks"]
    assert result["checks"]["bad_pixels"]["value"] > 0, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_cell_size(monkeypatch, name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    cell = spec.cell(name, spec.load_benchmark())
    # one acquisition in the window, or enough read calls for the check's sample
    seconds = 1.0 if cell.traffic["pattern"] == "acquisitions" else 10.0
    result = _control_run(monkeypatch, cell, seed, torch.device("cuda", 0), seconds)
    print(json.dumps({"control": name, "seed": seed, "attempted": result["attempted"],
                      "checks": result["checks"]}), flush=True)
    assert not result["correct"], result["checks"]
    assert result["checks"]["bad_pixels"]["value"] > 0, result["checks"]
