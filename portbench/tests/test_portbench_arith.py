"""The interval and roofline arithmetic on hand-made intervals, traces and
shapes."""

import json
import types

import numpy as np
import pytest

from portbench import roofline, spec, tracefile


def test_union_and_gaps():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 11.0)]
    assert tracefile.union_s(intervals) == pytest.approx(4.0)
    assert tracefile.union_s([]) == 0.0
    assert tracefile.gaps(intervals, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert tracefile.gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    assert tracefile.gaps([(0.0, 9.0)], 1.0, 2.0) == []


@pytest.mark.parametrize("name, op", [
    ("encode_tile_kernel(unsigned short const*, unsigned short const*, EncodeArgs)",
     "encode_tile_kernel"),
    ("void label_link_kernel<8>(unsigned char const*, int*)", "label_link_kernel"),
    ("bitpack12_kernel", "bitpack12_kernel"),
    ("(anonymous namespace)::decode_count_kernel(unsigned char const*, int*)",
     "decode_count_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Fn>(int, Fn)",
     "vectorized_elementwise_kernel"),
])
def test_op_name(name, op):
    assert tracefile.op_name(name) == op


def _trace(tmp_path, device, spans):
    """A Chrome trace of (cat, name, start us, duration us) device events
    and (name, start us, duration us) annotations."""
    events = [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in device]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": t, "dur": d}
               for n, t, d in spans]
    events.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 5})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracefile.Trace(path, "portbench.window")


def test_trace(tmp_path):
    trace = _trace(tmp_path, [
        ("kernel", "encode_tile_kernel(x)", 100, 50),
        ("kernel", "encode_place_kernel(x)", 140, 20),      # overlaps the first
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 300, 100),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 620, 90),
        ("gpu_memset", "Memset (Device)", 950, 80),           # runs past the window
        ("cpu_op", "aten::sum", 0, 1000),
    ], [("portbench.window", 0, 1000), ("server.run", 0, 500), ("merge_parts", 500, 500)])
    assert (trace.lo, trace.hi) == (0.0, pytest.approx(1e-3))
    assert trace.busy_s() == pytest.approx((60 + 100 + 90 + 50) * 1e-6)
    assert tracefile.union_s(trace.intervals("gpu_memcpy", "HtoD")) == pytest.approx(1e-4)
    assert trace.op_seconds(("encode_tile_kernel", "bitpack12_kernel")) == \
        {"encode_tile_kernel": pytest.approx(5e-5)}
    out = trace.breakdown()
    assert out["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(1e-4)]
    assert [name for name, _ in out["idle_gaps"]] == ["merge_parts", "merge_parts",
                                                      "server.run", "server.run"]
    assert out["idle_gaps"][0][1] == pytest.approx(2.4e-4)


def test_trace_needs_one_window(tmp_path):
    with pytest.raises(RuntimeError):
        _trace(tmp_path, [], [])


def _run(tmp_path, ops, launches, steps, fg_counts, kind="NVIDIA H100 80GB HBM3"):
    trace = _trace(tmp_path, [("kernel", f"{op}(args)", 10 * i, us) for i, (op, us)
                              in enumerate(ops)], [("portbench.window", 0, 10 ** 6)])
    return types.SimpleNamespace(
        trace=trace, device_kind=kind, height=64, width=128, bit_depth=12,
        fg_counts=np.array(fg_counts), launches=launches, steps=steps,
        done=lambda: [s for s in steps if s["ok"]],
        frames_done=lambda: sum(s["frames"] for s in steps if s["ok"]))


def test_l1_reduce_roofline(tmp_path):
    n = 64 * 128
    steps = [{"ok": True, "frames": 2, "offset": 0}, {"ok": True, "frames": 2, "offset": 1},
             {"ok": False, "frames": 0}]
    run = _run(tmp_path, [("encode_tile_kernel", 3), ("encode_place_kernel", 1),
                          ("bitpack12_kernel", 1)], {"encode_l1": 4}, steps, [10, 3, 7])
    # acquisitions of pool frames 0-1 and 1-2; 4 launches read the threshold
    per = [2 * n + n // 8 + (c * 12 + 7) // 8 for c in (10, 3, 7)]
    moved = per[0] + 2 * per[1] + per[2] + 4 * 2 * n
    want = 100 * moved / 3.35e12 / 5e-6
    assert spec.metric_reader("l1_reduce_roofline_pct")(run) == pytest.approx(want)


def test_l1_decode_roofline(tmp_path):
    n = 64 * 128
    steps = [{"ok": True, "frames": 2, "start": 0}, {"ok": True, "frames": 2, "start": 1}]
    run = _run(tmp_path, [("bitunpack12_kernel", 1), ("decode_count_kernel", 1),
                          ("decode_expand_kernel", 2)], {}, steps, [10, 3, 7])
    per = [n // 8 + (c * 12 + 7) // 8 + 2 * n for c in (10, 3, 7)]
    want = 100 * (per[0] + 2 * per[1] + per[2]) / 3.35e12 / 4e-6
    assert spec.metric_reader("l1_decode_roofline_pct")(run) == pytest.approx(want)


def test_l4_label_roofline(tmp_path):
    n = 64 * 128
    ops = [("label_mask_kernel", 2), ("label_link_kernel", 1), ("label_rank_kernel", 1),
           ("label_accumulate_kernel", 1), ("label_finalize_kernel", 2)]
    run = _run(tmp_path, ops, {"label_l2l4": 3}, [{"ok": True, "frames": 6}], [1] * 6)
    want = 100 * (6 * (2 * n + n // 8) + 3 * 2 * n) / 3.35e12 / 7e-6
    assert spec.metric_reader("l4_label_roofline_pct")(run) == pytest.approx(want)


def test_roofline_reads_nothing_without_its_ops_or_peak(tmp_path):
    run = _run(tmp_path, [("tokenize_kernel", 5)], {}, [{"ok": True, "frames": 1}], [1])
    assert spec.metric_reader("l4_label_roofline_pct")(run) is None
    # one listed kernel renamed or fused away: the share stays silent, not higher
    run = _run(tmp_path, [("encode_tile_kernel", 3), ("encode_place_kernel", 1)],
               {"encode_l1": 1}, [{"ok": True, "frames": 1, "offset": 0}], [1])
    assert spec.metric_reader("l1_reduce_roofline_pct")(run) is None
    ops = [(op, 1) for op in ("bitunpack12_kernel", "decode_count_kernel",
                              "decode_expand_kernel")]
    run = _run(tmp_path, ops, {}, [{"ok": True, "frames": 1, "start": 0}], [1], kind="cpu")
    assert spec.metric_reader("l1_decode_roofline_pct")(run) is None
    assert roofline.packed_bytes(3, 12) == 5 and roofline.bitmap_bytes(9) == 2


def test_read_call_latencies():
    steps = [{"ok": True, "latency_s": t} for t in (0.1, 0.3, 0.2, 0.4)]
    steps.append({"ok": False, "latency_s": 1.0})     # a failed call still waited
    run = types.SimpleNamespace(steps=steps)
    assert spec.metric_reader("read_call_p50_ms")(run) == pytest.approx(300.0)
    assert spec.metric_reader("read_call_p95_ms")(run) == pytest.approx(880.0)
