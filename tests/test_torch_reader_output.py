"""What ``read_frames_dense`` hands its caller, on the CPU: a fresh,
writable array on every call that shares memory with no other output
still alive, with the frames of the container; the CPU's route is the
pageable one (no ``reader.d2h_pinned`` span), and no reader's ``close()``
empties the host allocator's cache.  The card's pinned route is tested in
``test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

import pyrecode_tpu_torch as port
from test_torch_slice import EPSILON, NODES, _fixture, _params, _residuals

CPU = [torch.profiler.ProfilerActivity.CPU]


def _gap_chain_frames(rng, shape):
    """Frames of ~70000 foreground pixels at 1024^2 (``test_torch_rans_slice``):
    the writer's device rANS coders engage, and the reader takes the gap
    chain."""
    dark = rng.integers(0, 30, shape[1:]).astype(np.uint16)
    data = (dark + rng.integers(0, EPSILON + 1, shape)).astype(np.uint16)
    fg = rng.random(shape) < 0.067
    data[fg] = np.minimum(dark[None].repeat(shape[0], 0)[fg] + EPSILON + 1
                          + rng.exponential(6.0, int(fg.sum())).astype(np.int64), 4095)
    return data, dark


@pytest.fixture(scope="module", params=[0, 12], ids=["scheme0", "scheme12"])
def container(request, tmp_path_factory):
    """(scheme, the frames' residuals, a merged L1 container): at scheme 0
    the slice's frames through host inflate and the decode twin; at scheme
    12 frames that read through the device gap chain's twins, which returns
    before inflate.  The two return sites of ``read_frames_dense``."""
    scheme = request.param
    if scheme == 0:
        (data, dark), nodes, kwargs = _fixture(), NODES, {}
    else:
        data, dark = _gap_chain_frames(np.random.default_rng(7), (3, 1024, 1024))
        nodes, kwargs = 1, {"device_entropy": True}
    out = tmp_path_factory.mktemp(f"reader_output_{scheme}")
    params = _params(shape=data.shape, num_threads=nodes, compression_scheme=scheme)
    for node_id in range(nodes):
        w = port.ReCoDeWriter("test_data", dark_data=dark, output_directory=str(out),
                              input_params=params, node_id=node_id, device="cpu", **kwargs)
        w.start()
        w.run(data)
        w.close()
    return scheme, _residuals(data, dark), port.merge_parts(str(out), "test_data.rc1", nodes)


@pytest.fixture(autouse=True)
def _clean_span_table():
    port.reset_span_totals()
    yield
    port.reset_span_totals()


def test_live_outputs_are_fresh(container):
    _, want, merged = container
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    try:
        a = reader.read_frames_dense(0, 2)
        b = reader.read_frames_dense(1, 2)
        c = reader.read_frames_dense(0, 2)
        host = reader.read_frames_dense(0, 2, use_tpu=False)
    finally:
        reader.close()
    for got, start in ((a, 0), (b, 1), (c, 0)):
        assert got.dtype == np.uint16 and got.flags.writeable
        assert np.array_equal(got, want[start:start + 2])
    assert np.array_equal(a, host)
    for x, y in ((a, b), (a, c), (b, c)):
        assert not np.shares_memory(x, y)
    a[...] = 1   # the caller's to write: no other output changes
    assert np.array_equal(b, want[1:3]) and np.array_equal(c, want[:2])


def test_cpu_read_takes_the_pageable_route(container, monkeypatch):
    scheme, _, merged = container

    def refuse():
        raise AssertionError("a reader emptied the pinned host cache")

    # the caching host allocator's empty call, wherever the installed torch has it
    for owner, name in ((torch.accelerator, "empty_host_cache"), (torch._C, "_host_emptyCache")):
        if hasattr(owner, name):
            monkeypatch.setattr(owner, name, refuse)
    reader = port.ReCoDeReader(merged, device="cpu")
    reader.open()
    try:
        plain = reader.read_frames_dense(1, 2)
        with torch.profiler.profile(activities=CPU):
            got = reader.read_frames_dense(1, 2)
    finally:
        reader.close()
    # nor does a reader on the card: its pinned blocks stay cached for the
    # process's next outputs and writer buffers
    on_card = port.ReCoDeReader(merged, device="cpu")
    on_card.open()
    on_card._device = torch.device("cuda")
    on_card.close()
    assert np.array_equal(got, plain) and not np.shares_memory(got, plain)
    totals = port.span_totals()
    assert totals["reader.d2h"][0] == 1
    assert "reader.d2h_pinned" not in totals
    assert ("reader.inflate" in totals) == (scheme == 0)   # which return site
