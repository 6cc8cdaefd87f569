"""The plain reader and the plain reference against small containers
written by the program on the CPU, and the reader's refusals."""

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from portbench import frames, reference
from portbench.plain_reader import HEADER_FIELDS, ContainerError, PlainContainer
from portbench.tests.small import SEED, small_cell

H, W, N = 48, 80, 7


def _write(tmp_path, name, level=None, scheme=0):
    cell = small_cell(name, H, W, N)
    params = dict(cell.config["params"])
    if level is not None:
        params.update(reduction_level=level)
    params.update(compression_scheme=scheme)
    data, dark, counts = frames.make(cell.traffic["frames"], N, H, W, 12, 2, SEED,
                                     torch.device("cpu"))
    input_params = port.InputParams(dict(
        params, num_cols=W, num_rows=H, num_frames=N, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, source_file_type=0,
        source_header_length=0, keep_calibration_data=1, calibration_file_type=0,
        source_data_type=0, target_data_type=0))
    init = port.InitParams("batch", str(tmp_path), image_filename="acq",
                           log_filename=str(tmp_path / "log"), verbosity=0)
    port.ReCoDeServer("batch", device="cpu").run(init, input_params, dark_data=dark, data=data)
    level = params["reduction_level"]
    merged = port.merge_parts(str(tmp_path), f"acq.rc{level}", params["num_threads"])
    return merged, data, reference.threshold(dark, 2), counts, level


@pytest.mark.parametrize("name, level", [("de16_l1_zlib.write", None),
                                         ("de16_l4_centroid.write", None),
                                         ("de16_l4_centroid.write", 3)])
def test_plain_reader_against_program(tmp_path, name, level):
    merged, data, thr, counts, level = _write(tmp_path, name, level)
    container = PlainContainer(merged)
    assert (container.nz, container.ny, container.nx, container.level) == (N, H, W, level)
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    dense = reader.read_frames_dense(0, N)
    reader.close()
    for z in range(N):
        got = container.dense(z)
        np.testing.assert_array_equal(got, dense[z])
        if level == 3:
            np.testing.assert_array_equal(got, data[z] > thr)
        else:
            np.testing.assert_array_equal(got, reference.expected(level, data[z], thr))
    if level == 1:
        assert [int(np.count_nonzero(container.dense(z))) for z in range(N)] == list(counts)


def test_reference_l4_centroids():
    frame = np.zeros((6, 9), np.uint16)
    frame[1, 1:3] = (10, 30)        # weighted column 1.75 -> 2
    frame[4, 4:6] = (20, 20)        # column 4.5 -> 4 (half to even)
    frame[3:5, 8] = (7, 7)          # row 3.5 -> 4 (half to even)
    frame[0, 6] = 9                 # a single pixel
    want = np.zeros_like(frame)
    for r, c in ((1, 2), (4, 4), (4, 8), (0, 6)):
        want[r, c] = 1
    np.testing.assert_array_equal(reference.l4_dense(frame, np.full_like(frame, 2)), want)


@pytest.mark.parametrize("damage", ["truncate", "stream", "table", "scheme"])
def test_plain_reader_refuses_damage(tmp_path, damage):
    merged, *_ = _write(tmp_path, "de16_l1_zlib.write")
    raw = bytearray(open(merged, "rb").read())
    container = PlainContainer(merged)
    if damage == "truncate":
        raw = raw[:-3]
    elif damage == "stream":
        raw[container.offsets[2] + 5] ^= 0xFF
    elif damage == "table":
        raw[container.offsets[0] - 12] ^= 0x01        # frame N-1's compressed bitmap size
    else:
        names = [name for name, _ in HEADER_FIELDS]
        at = sum(size for _, size in HEADER_FIELDS[:names.index("compression_scheme")])
        raw[at] = 7                                     # a scheme with no plain decoder
    open(merged, "wb").write(bytes(raw))
    with pytest.raises(ContainerError):
        c = PlainContainer(merged)
        for z in range(c.nz):
            c.dense(z)
