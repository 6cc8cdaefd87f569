"""The port's tools layer (``pyrecode_tpu_torch/utils``) against the JAX
package's on the CPU: calibration, backscattering, the offline converters,
the live viewers and the validation frames.  The same numpy inputs from a
seed go through both.  Tolerances: medians, thresholds, event counts,
centroid maps and views exact; std and sigma within 1e-5 relative;
nearest-neighbor distances (float32 in both) within 1e-5 relative.
"""

import numpy as np
import pytest
from scipy.sparse import coo_matrix

from pyrecode_tpu.utils import backscatter as jax_bs
from pyrecode_tpu.utils import calibration as jax_cal
from pyrecode_tpu.utils import converters as jax_conv
from pyrecode_tpu.utils import converters_mt as jax_conv_mt
from pyrecode_tpu.utils import validate as jax_validate
from pyrecode_tpu.utils import viewer as jax_viewer
from pyrecode_tpu_torch import InputParams, ReCoDeWriter, merge_parts, oracle
from pyrecode_tpu_torch.utils import backscatter as bs
from pyrecode_tpu_torch.utils import calibration, converters, converters_mt, validate
from pyrecode_tpu_torch.utils.viewer import ReCoDeViewer, ReCoDeViewerMT

CPU = "cpu"


def _flat_field(n, shape=(24, 20), seed=0, dose=0.05):
    """uint16 flat-field frames: Gaussian dark noise and sparse events."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(100, 4, size=(n, *shape))
    frames += (rng.random((n, *shape)) < dose) * rng.integers(15, 60, size=(n, *shape))
    return np.clip(np.rint(frames), 0, 4095).astype(np.uint16)


class TestCalibration:
    @pytest.mark.parametrize("n", [7, 8])
    def test_median_std_vs_jax(self, n):
        frames = _flat_field(n, seed=n)
        med, std = calibration.pixel_median_std(frames, device=CPU)
        want_med, want_std = jax_cal.pixel_median_std(frames)
        assert med.dtype == np.float32 and std.dtype == np.float32
        assert np.array_equal(med, want_med)
        np.testing.assert_allclose(std, want_std, rtol=1e-5)
        # an even count averages the two middle values; the std is the population std
        np.testing.assert_array_equal(med, np.median(frames.astype(np.float32), axis=0))
        np.testing.assert_allclose(std, np.std(frames.astype(np.float64), axis=0), rtol=1e-5)
        if n % 2 == 0:
            assert (med != np.floor(med)).any()

    def test_median_std_float_frames(self):
        frames = np.random.default_rng(1).normal(100, 5, size=(50, 32, 32)).astype(np.float32)
        med, std = calibration.pixel_median_std(frames, device=CPU)
        want_med, want_std = jax_cal.pixel_median_std(frames)
        assert np.array_equal(med, want_med)
        np.testing.assert_allclose(std, want_std, rtol=1e-5)

    @pytest.mark.parametrize("k", [1, 3, 29])
    def test_accurate_thresholds_vs_jax(self, k):
        frames = np.random.default_rng(3).normal(100, 4, size=(30, 16, 16)).astype(np.float32)
        base = np.median(frames, axis=0).astype(np.float32)
        got = calibration.accurate_pixel_thresholds(frames, base, k, device=CPU)
        want = jax_cal.accurate_pixel_thresholds(frames, base, k)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert np.isfinite(got).all() and (got >= base - 1e-3).all()

    def test_accurate_thresholds_keep_the_base_where_too_few_values(self):
        frames = _flat_field(16, seed=4)
        base = np.full(frames.shape[1:], 130, np.float32)
        got = calibration.accurate_pixel_thresholds(frames, base, 5, device=CPU)
        assert np.array_equal(got, jax_cal.accurate_pixel_thresholds(frames, base, 5))
        assert (got == 130).any() and np.isfinite(got).all()

    def test_make_calibration_frames_vs_jax(self, tmp_path):
        frames = _flat_field(40, seed=2)
        kwargs = dict(nFrames=40, n_stats_frames=10, n_sigmas=4, filename_prefix="cal",
                      frames=frames, verbose=False, use_acc=True, sigma_acc=3)
        (tmp_path / "port").mkdir()
        (tmp_path / "jax").mkdir()
        got = calibration.make_calibration_frames(None, np.uint16, savepath=str(tmp_path / "port"),
                                                  device=CPU, **kwargs)
        want = jax_cal.make_calibration_frames(None, np.uint16, savepath=str(tmp_path / "jax"),
                                               **kwargs)
        assert np.array_equal(got["median"], want["median"])
        np.testing.assert_allclose(got["std"], want["std"], rtol=1e-5)
        assert got["sigma"] == pytest.approx(want["sigma"], rel=1e-5)
        assert got["thresholds"].keys() == want["thresholds"].keys() == {0, 1, 2, 3, "3A"}
        for key in want["thresholds"]:
            assert np.array_equal(got["thresholds"][key], want["thresholds"][key]), key
        assert got["statistics"] == want["statistics"]
        for name in sorted(p.name for p in (tmp_path / "jax").iterdir()):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        fracs = [got["statistics"][i]["avg_foreground_fraction"] for i in range(4)]
        assert fracs == sorted(fracs, reverse=True)

    def test_fit_sigma_and_count_events_vs_jax(self):
        frames = _flat_field(12, seed=5)
        median = np.median(frames, axis=0).astype(np.float32)
        assert calibration.fit_global_sigma(frames, median, 6) == pytest.approx(
            jax_cal.fit_global_sigma(frames, median, 6), rel=1e-5)
        thr = (median + 8).astype(np.uint16)
        assert calibration.count_events(frames[0], thr) == jax_cal.count_events(frames[0], thr)


def _decoded_l1_frames(n=6, shape=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4096, size=(n, *shape)).astype(np.int64) - 3600
    data[data < 0] = 0
    data = data.astype(np.uint16)
    return {i: {"metadata": {"frame_id": i}, "data": coo_matrix(data[i])}
            for i in range(n)}, data


def _same_frames(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key]["data"].dtype == want[key]["data"].dtype
        assert np.array_equal(np.asarray(got[key]["data"].todense()),
                              np.asarray(want[key]["data"].todense())), key


class TestConverters:
    @pytest.mark.parametrize("old,new,eps", [(10, 10, 0.0), (20, 25, 0.0), (30, 12, 1.5)])
    def test_recalibrate_vs_jax(self, old, new, eps):
        frames, _ = _decoded_l1_frames(seed=4)
        kwargs = dict(original_calibration_frame=np.full((64, 64), old, np.uint16),
                      new_calibration_frame=np.full((64, 64), new, np.uint16), epsilon=eps)
        got = converters.recalibrate_l1(frames, **kwargs)
        _same_frames(got, jax_conv.recalibrate_l1(frames, **kwargs))
        assert got[0]["metadata"] == {"frame_id": 0}

    @pytest.mark.parametrize("method,area", [("weighted_average", 0), ("unweighted", 0),
                                             ("max", 0), ("weighted_average", 2)])
    def test_l1_to_l4_converter_vs_jax(self, method, area):
        frames, data = _decoded_l1_frames(seed=5)
        got = converters.l1_to_l4_converter(frames, (64, 64), method=method, area_threshold=area)
        _same_frames(got, jax_conv.l1_to_l4_converter(frames, (64, 64), method=method,
                                                      area_threshold=area))
        if area == 0:
            enc = oracle.reduce_frame(data[0], np.zeros_like(data[0]), 4, 12, l4_scheme=method)
            expected = oracle.unpack_binary_frame(
                np.frombuffer(enc["packed_binary_map"], np.uint8), 64 * 64).reshape(64, 64)
            assert np.array_equal(np.asarray(got[0]["data"].todense()), expected.astype(bool))

    def test_l1_to_l4_mt_vs_jax(self):
        frames, _ = _decoded_l1_frames(n=8, seed=7)
        single = converters_mt.L1_to_L4(frames, (64, 64), batch_size=3, device=CPU)
        multi = converters_mt.L1_to_L4_mt(frames, (64, 64), n_workers=3, device=CPU)
        want = jax_conv_mt.L1_to_L4(frames, (64, 64), batch_size=3)
        assert list(multi) == list(range(8))
        _same_frames(single, want)
        _same_frames(multi, want)
        assert multi[5]["metadata"] == {"frame_id": 5}

    def test_de16_common_mode_vs_jax(self):
        rng = np.random.default_rng(8)
        for frame in (rng.integers(100, 200, size=(16, 512)).astype(np.uint16),
                      rng.normal(150, 9, size=(8, 300)).astype(np.float32)):
            got = converters.apply_DE16_common_mode_correction(frame)
            want = jax_conv.apply_DE16_common_mode_correction(frame)
            assert got.dtype == want.dtype and np.array_equal(got, want)

    def test_read_dark_ref(self, tmp_path):
        ref = np.arange(64, dtype=np.uint16).reshape(8, 8)
        path = tmp_path / "dark.bin"
        path.write_bytes(ref.tobytes() + b"trailing")
        out = converters.read_dark_ref(str(path), (8, 8), np.uint16)
        assert np.array_equal(out, ref)
        assert np.array_equal(out, jax_conv.read_dark_ref(str(path), (8, 8), np.uint16))


def _params(n, shape, num_threads):
    p = InputParams(dict(
        reduction_level=1, rc_operation_mode=1, calibration_threshold_epsilon=0,
        target_bit_depth=12, source_bit_depth=12, num_cols=shape[1], num_rows=shape[0],
        num_frames=n, frame_offset=0, num_calibration_frames=1,
        calibration_frame_offset=0, keep_part_files=0, num_threads=num_threads,
        l2_statistics=0, l4_centroiding=0, compression_scheme=0,
        compression_level=1, source_file_type=0, source_header_length=0,
        keep_calibration_data=1, calibration_file_type=0, source_data_type=0,
        target_data_type=0))
    assert p.validate()
    return p


def _write_parts(out_dir, name, data, num_threads, **kwargs):
    for node_id in range(num_threads):
        w = ReCoDeWriter(name, dark_data=np.zeros(data.shape[1:], np.uint16),
                         output_directory=str(out_dir),
                         input_params=_params(len(data), data.shape[1:], num_threads),
                         node_id=node_id, device=CPU, **kwargs)
        w.start()
        w.run(data)
        w.close()


def _viewer_data(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4096, size=(6, 64, 64)).astype(np.int64) - 3500
    data[data < 0] = 0
    return data.astype(np.uint16)


class TestViewer:
    def test_live_view_vs_jax(self, tmp_path):
        data = _viewer_data(9)
        _write_parts(tmp_path, "view_data", data, 2)
        viewers = [ReCoDeViewer(str(tmp_path), "view_data.rc1", 2, fractionation=3,
                                device=CPU),
                   jax_viewer.ReCoDeViewer(str(tmp_path), "view_data.rc1", 2, fractionation=3)]
        for start in (0, 3):
            views = [v.get_next_view() for v in viewers]
            assert views[0]["start"] == views[1]["start"] == start
            assert views[0]["n_frames"] == 3
            assert np.array_equal(views[0]["view"], views[1]["view"])
            assert np.array_equal(views[0]["view"],
                                  data[start:start + 3].sum(axis=0).astype(np.float64))
        for v in viewers:
            v.close()

    def test_live_view_restores_a_short_read(self, tmp_path):
        """A part file cut inside a frame: the viewer returns the frames that
        are whole, restores the file position, and reads the rest once the
        writer has appended it (viewer.py:40-52)."""
        data = _viewer_data(11)
        (tmp_path / "full").mkdir()
        _write_parts(tmp_path / "full", "cut", data, 1)
        full = (tmp_path / "full" / "cut.rc1_part000").read_bytes()
        part = tmp_path / "cut.rc1_part000"
        part.write_bytes(full[:len(full) - 40])
        viewer = ReCoDeViewer(str(tmp_path), "cut.rc1", 1, fractionation=6, device=CPU)
        first = viewer.get_next_view()
        assert first["start"] == 0 and first["n_frames"] == 5
        assert np.array_equal(first["view"], data[:5].sum(axis=0).astype(np.float64))
        assert viewer.get_next_view()["n_frames"] == 0
        with open(part, "ab") as fp:
            fp.write(full[len(full) - 40:])
        second = viewer.get_next_view()
        assert second["start"] == 5 and second["n_frames"] == 1
        assert np.array_equal(second["view"], data[5].astype(np.float64))
        viewer.close()

    def test_live_view_mt(self, tmp_path):
        data = _viewer_data(10)
        _write_parts(tmp_path, "mt_data", data, 2)
        viewer = ReCoDeViewerMT(str(tmp_path), "mt_data.rc1", 2, fractionation=3, device=CPU)
        v1 = viewer.get_next_view(timeout=10)
        assert v1["start"] == 0 and v1["n_frames"] == 3
        assert np.array_equal(v1["view"], data[:3].sum(axis=0).astype(np.float64))
        v2 = viewer.get_next_view(timeout=10)
        assert np.array_equal(v2["view"], data[3:6].sum(axis=0).astype(np.float64))
        viewer.close()


def test_validation_frames_vs_jax(tmp_path):
    rng = np.random.default_rng(20)
    data = np.where(rng.random((6, 64, 64)) < 0.05,
                    rng.integers(1, 4096, (6, 64, 64)), 0).astype(np.uint16)
    dark = np.zeros((64, 64), np.uint16)
    _write_parts(tmp_path, "val_data", data, 1, validation_frame_gap=2)
    merged = merge_parts(str(tmp_path), "val_data.rc1", 1)
    vf = tmp_path / "val_data_part000_validation_frames.bin"
    loaded = validate.load_validation_frames(str(vf), 64, 64)
    assert np.array_equal(loaded, data[::2])
    report = validate.verify_against_validation_frames(merged, str(vf), 2, dark=dark,
                                                       device=CPU)
    assert report == jax_validate.verify_against_validation_frames(merged, str(vf), 2, dark=dark)
    assert report["all_match"] and set(report["frames"]) == {0, 2, 4}
    raw = bytearray(vf.read_bytes())
    raw[100] ^= 0xFF
    vf.write_bytes(bytes(raw))
    report = validate.verify_against_validation_frames(merged, str(vf), 2, dark=dark,
                                                       device=CPU)
    assert not report["all_match"]
    assert report == jax_validate.verify_against_validation_frames(merged, str(vf), 2, dark=dark)


class TestBackscatter:
    def test_nn_distances_batch_vs_numpy_and_jax(self):
        rng = np.random.default_rng(0)
        frames = [rng.uniform(0, 100, (n, 2)) for n in (5, 2, 17, 1, 0, 30)]
        ref = np.concatenate([bs.nn_distances(c) for c in frames if len(c) >= 2])
        got = bs.nn_distances_batch(frames, device=CPU)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(np.sort(got), np.sort(ref), rtol=1e-5)
        np.testing.assert_allclose(got, jax_bs.nn_distances_batch(frames), rtol=1e-5)
        assert bs.nn_distances_batch([], device=CPU).size == 0
        assert bs.nn_distances_batch([frames[3]], device=CPU).size == 0

    def test_host_functions_vs_jax(self):
        events = bs.simulate_events([100, 40, 1], ratio=9.0, scale=2.0, shape=(64, 64),
                                    rng=np.random.default_rng(1))
        want = jax_bs.simulate_events([100, 40, 1], ratio=9.0, scale=2.0, shape=(64, 64),
                                      rng=np.random.default_rng(1))
        assert all(np.array_equal(a, b) for a, b in zip(events, want))
        assert all((c >= 0).all() and (c < 64).all() for c in events)
        rng = np.random.default_rng(2)
        a, b = rng.normal(0, 1, 500), rng.normal(0.3, 1, 400)
        assert bs.ks_statistic(a, b) == jax_bs.ks_statistic(a, b)
        assert bs.fisher_combined([1e-4, 0.2, 0.5]) == jax_bs.fisher_combined([1e-4, 0.2, 0.5])
        assert bs.nn_distances(events[2]).size == 0

    def test_sweep_vs_jax(self):
        observed = bs.simulate_events([60] * 6, ratio=4.0, scale=2.0, shape=(128, 128),
                                      rng=np.random.default_rng(3))
        kwargs = dict(ratios=[1.0, 4.0, 40.0], scales=[2.0], shape=(128, 128), n_sims=3)
        got = bs.sweep_backscatter_params(observed, rng=np.random.default_rng(4), device=CPU,
                                          **kwargs)
        host = bs.sweep_backscatter_params(observed, rng=np.random.default_rng(4),
                                           device=False, **kwargs)
        want = jax_bs.sweep_backscatter_params(observed, rng=np.random.default_rng(4), **kwargs)
        assert got["best"] == want["best"] == host["best"]
        np.testing.assert_allclose(got["D"], want["D"], rtol=1e-5)
        np.testing.assert_allclose(got["q"], want["q"], rtol=1e-5)
        np.testing.assert_allclose(got["D"], host["D"], rtol=1e-5)
