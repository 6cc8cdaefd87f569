"""The port's scheme-12 writer at L3 and L2 sum against the JAX writer,
byte for byte, at a size where the device gap coder engages.

One batch of two 1024x1024 frames at ~7% foreground: each bitmap holds
more than 65536 set bits, so it is gap-coded at 1024 lanes from the
positions of the bitmap -> positions kernel (its twin here; the JAX writer
runs ``bitmap_positions_pallas`` and its rANS kernels in interpret mode,
about 20-30 s a config).  The L2 statistics streams hold more set bits
than bytes and take the host coder in both writers.  The density stays
below 8%, off the JAX L1 encode kernel's capacity ladder, which would
re-encode the L3 batch on the host (ROADMAP Queue 3).
"""

import filecmp

import numpy as np
import pytest

import pyrecode_tpu_torch as port
from pyrecode_tpu.writer import ReCoDeWriter as JaxWriter
from pyrecode_tpu_torch import oracle
from pyrecode_tpu_torch.codecs import rans as trans
from test_torch_slice import EPSILON, _params

SHAPE = (2, 1024, 1024)


def _frames():
    rng = np.random.default_rng(5)
    dark = rng.integers(0, 30, SHAPE[1:]).astype(np.uint16)
    data = (dark + rng.integers(0, EPSILON + 1, SHAPE)).astype(np.uint16)
    fg = rng.random(SHAPE) < 0.07
    base = np.broadcast_to(dark, SHAPE)[fg].astype(np.int64)
    data[fg] = np.minimum(base + EPSILON + 1
                          + rng.exponential(6.0, int(fg.sum())).astype(np.int64), 4095)
    return data, dark


@pytest.mark.parametrize("level,l2_code", [(3, 0), (2, 2)], ids=["L3", "L2-sum"])
def test_scheme12_part_files_match_jax(tmp_path, level, l2_code):
    data, dark = _frames()
    params = _params(shape=SHAPE, num_threads=1, compression_scheme=12, reduction_level=level,
                     l2_statistics=l2_code)
    parts = {}
    for name, cls, kwargs in (("jax", JaxWriter, dict(use_tpu=True)),
                              ("port", port.ReCoDeWriter, dict(device="cpu"))):
        out = tmp_path / name
        out.mkdir()
        w = cls("test_data", dark_data=dark, output_directory=str(out), input_params=params,
                mode="batch", node_id=0, buffer_size_in_frames=2, device_entropy=True, **kwargs)
        assert w._device_entropy is True
        w.start()
        w.run(data)
        w.close()
        parts[name] = out / f"test_data.rc{level}_part000"
    assert filecmp.cmp(parts["port"], parts["jax"], shallow=False)

    reader = port.ReCoDeReader(str(parts["port"]), is_intermediate=True, device="cpu")
    reader.open()
    thr = dark.astype(np.int64) + EPSILON
    for z in range(SHAPE[0]):
        raw = reader.get_next_frame_raw()[z]["data"]
        enc = oracle.reduce_frame(data[z], thr.astype(np.uint16), level, 12, l2_statistic="sum")
        h = trans._parse_header(raw["binary_map"])
        assert h["gap"] and h["nways"] == 1024 and h["m"] >= 65536
        assert trans.decompress(raw["binary_map"]) == enc["packed_binary_map"]
        if level == 2:
            assert trans.decompress(raw["pixvals"]) == enc["packed_pixvals"]
    reader.close()
