"""The edge cases of tests/test_edge_cases.py on the port: empty slices, odd
dtypes and bit depths, degenerate frames and a raw binary source file.  The
port's writer (``device="cpu"``: the kernels' plain twins) and the JAX
package's (its host path, ``use_tpu=False``) write the same part files and
merged containers, byte for byte, and the port reads every frame back.
"""

from pathlib import Path

import numpy as np
import pytest

import pyrecode_tpu as jax_pkg
import pyrecode_tpu_torch as port
from pyrecode_tpu.reader import merge_parts as jax_merge_parts
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter


def _sparse(rng, shape, occupancy, top, dtype=np.uint16):
    return np.where(rng.random(shape) < occupancy, rng.integers(1, top, shape), 0).astype(dtype)


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    return {
        "more_nodes_than_frames": (_sparse(rng, (2, 64, 64), 0.05, 4096), 3, {}),
        "all_zero_frames": (np.zeros((3, 64, 64), np.uint16), 1, {}),
        "fully_saturated_frames": (np.full((2, 64, 128), 4095, np.uint16), 1, {}),
        "uint8_source_bit_depth_8": (_sparse(rng, (3, 64, 64), 0.1, 255, np.uint8), 1,
                                     dict(source_bit_depth=8, target_bit_depth=8)),
        "bit_depth_16": (_sparse(rng, (3, 64, 64), 0.05, 65535), 1,
                         dict(source_bit_depth=16, target_bit_depth=16)),
        "non_square_frames": (_sparse(rng, (2, 48, 160), 0.05, 4096), 2, {}),
        "width_not_multiple_of_8": (_sparse(rng, (2, 32, 36), 0.1, 4096), 1, {}),
        "l2_sum": (_sparse(rng, (3, 128, 128), 0.03, 4096), 1,
                   dict(reduction_level=2, l2_statistics=2)),
        "single_frame_single_node": (_sparse(rng, (1, 64, 64), 0.05, 4096), 1, {}),
        # batches of 4 + 1: the host pool, then the one-frame batch by the codec
        "last_batch_one_frame": (_sparse(rng, (5, 64, 64), 0.05, 4096), 1,
                                 dict(buffer_size_in_frames=4)),
        "last_batch_one_frame_scheme12": (_sparse(rng, (5, 64, 64), 0.05, 4096), 1,
                                          dict(buffer_size_in_frames=4, compression_scheme=12)),
    }[name]


def _params(pkg, shape, num_threads, **overrides):
    values = dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[2], num_rows=shape[1],
        num_frames=shape[0], frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=1, num_threads=num_threads,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0, compression_level=1,
        source_file_type=0, source_header_length=0, keep_calibration_data=1,
        calibration_file_type=0, source_data_type=0, target_data_type=0)
    values.update(overrides)
    p = pkg.InputParams(values)
    assert p.validate()
    return p


def _write_both(tmp_path, image, data, num_threads, buffer_size_in_frames=None, **overrides):
    """Part files and merged container of each package, each writer with
    ``buffer_size_in_frames`` where given; returns the merged file's path."""
    shape = data.shape if data is not None else overrides.pop("shape")
    dtype = data.dtype if data is not None else np.uint16
    batch = {} if buffer_size_in_frames is None else {"buffer_size_in_frames": buffer_size_in_frames}
    outs = {}
    for name, pkg, writer_cls, merge, kwargs in (
            ("port", port, port.ReCoDeWriter, port.merge_parts, dict(device="cpu")),
            ("jax", jax_pkg, JaxWriter, jax_merge_parts, dict(use_tpu=False))):
        out = tmp_path / name
        out.mkdir()
        params = _params(pkg, shape, num_threads, **overrides)
        for node_id in range(num_threads):
            w = writer_cls(image, dark_data=np.zeros(shape[1:], dtype), output_directory=str(out),
                           input_params=params, node_id=node_id, **kwargs, **batch)
            w.start()
            w.run(data)
            w.close()
        base = f"{Path(image).stem}.rc{params.reduction_level}"
        merge(str(out), base, num_threads)
        outs[name] = out
    names = sorted(p.name for p in outs["jax"].iterdir())
    assert names == sorted(p.name for p in outs["port"].iterdir())
    for name in names:
        assert (outs["port"] / name).read_bytes() == (outs["jax"] / name).read_bytes(), name
    return outs["port"] / base


@pytest.mark.parametrize("case", ["more_nodes_than_frames", "all_zero_frames",
                                  "fully_saturated_frames", "uint8_source_bit_depth_8",
                                  "bit_depth_16", "non_square_frames", "width_not_multiple_of_8",
                                  "l2_sum", "single_frame_single_node",
                                  "last_batch_one_frame", "last_batch_one_frame_scheme12"])
def test_edge_case_bytes_match_jax(tmp_path, case):
    data, num_threads, overrides = _case(case)
    merged = _write_both(tmp_path, "edge_data", data, num_threads, **overrides)
    reader = port.ReCoDeReader(str(merged), device="cpu")
    reader.open()
    assert reader.get_shape() == data.shape
    for i in range(data.shape[0]):
        fd = reader.get_next_frame()
        if overrides.get("reduction_level") == 2:
            labels, num = port.oracle.label_components(data[i] > 0)
            want = np.minimum(port.oracle.l2_summary_stats(labels, data[i], num, "sum"), 4095)
            assert np.array_equal(fd[i]["summary_stats"][:num], want.astype(np.uint16)), i
        else:
            assert np.array_equal(fd[i]["data"].todense(), data[i]), i
    reader.close()


def test_binary_file_source(tmp_path):
    """tests/test_edge_cases.py:173: the writers read their slices from a raw
    binary source file."""
    rng = np.random.default_rng(7)
    data = _sparse(rng, (5, 64, 64), 0.05, 4096)
    src = tmp_path / "source.bin"
    src.write_bytes(data.tobytes())
    merged = _write_both(tmp_path, str(src), None, 2, shape=data.shape)
    reader = port.ReCoDeReader(str(merged), device="cpu")
    reader.open()
    assert np.array_equal(reader.read_frames_dense(0, 5), data)
    reader.close()
