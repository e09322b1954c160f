"""Idle share, span device time, roofline and MFU arithmetic on synthetic
traces and records."""

import math

import pytest

from harness import common, flops, registry, trace as tr


def _trace():
    # window 0..10 s; a cond span 0..1, a sample span 1..8, decode 8..10
    kernels = [(0.2, 0.6, "void gemm_kernel"),
               (1.0, 3.0, "void flash_kernel<float, 2>"),
               (2.5, 5.0, "vectorized_elementwise_kernel"),   # overlaps
               (8.5, 9.5, "sm90_xmma_fprop_implicit_gemm cudnn")]
    spans = [("window", 0.0, 10.0), ("cond", 0.0, 1.0),
             ("sample", 1.0, 8.0), ("decode", 8.0, 10.0)]
    return tr.Trace(kernels=kernels, spans=spans)


def test_busy_is_the_union_of_kernel_intervals():
    t = _trace()
    assert tr.busy_seconds(t, (0.0, 10.0)) == pytest.approx(0.4 + 4.0 + 1.0)
    assert tr.idle_share(t) == pytest.approx(1 - 5.4 / 10)
    assert tr.device_seconds_in(t, "sample") == pytest.approx(4.0)
    assert tr.device_seconds_in(t, "decode") == pytest.approx(1.0)
    assert tr.device_seconds_in(t, "optim") is None


def test_idle_gaps_are_named_by_the_innermost_span():
    gaps = tr.idle_gaps(_trace())
    assert gaps[0] == ("sample", pytest.approx(3.5))     # 5.0 .. 8.5
    assert ("cond", pytest.approx(0.4)) in gaps          # 0.6 .. 1.0
    assert sum(g for _, g in gaps) == pytest.approx(10 - 5.4)


def test_top_kernels_by_category():
    top = tr.top_kernels(_trace())
    assert top[0] == ("elementwise: vectorized_elementwise_kernel",
                      pytest.approx(2.5))
    assert top[1] == ("flash_attention: void flash_kernel<float, 2>",
                      pytest.approx(2.0))
    cats = tr.by_category(_trace())
    assert cats["cuDNN conv"] == pytest.approx(1.0)
    assert cats["GEMM"] == pytest.approx(0.4)


def test_markers_pair_into_spans():
    ms = [(2 * i, 2 * i + 1, "spin_kernel") for i in range(6)]
    spans = tr.pair_marks(ms, ["window", "step", "optim", "optim", "step",
                               "window"])
    assert spans == [("window", 1, 10), ("step", 3, 8), ("optim", 5, 6)]


class _Ev:
    """A raw profiler event of the device."""

    def __init__(self, name, a, b):
        self._n, self._a, self._b = name, a, b

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def _prof(events):
    class Results:
        def events(self):
            return events

    class Inner:
        kineto_results = Results()

    return type("Prof", (), {"profiler": Inner()})()


def test_a_trace_whose_markers_disagree_is_refused():
    evs = [_Ev("spin_kernel(long)", 0, 1000), _Ev("gemm", 2000, 3000)]
    with pytest.raises(RuntimeError, match="marker kernels"):
        tr.from_profiler(_prof(evs), ["window", "window"])
    t = tr.from_profiler(_prof(evs + [_Ev("spin_kernel(long)", 5000, 6000)]),
                         ["window", "window"])
    assert t.window == pytest.approx((1e-6, 5e-6)) and len(t.kernels) == 1


def _record(**kw):
    rec = common.Record(kind="sample", images=64, window_s=8.0,
                        traced_units=1, trace=_trace())
    rec.work = {"batch": 32, "calls": 42, "unet": 4.0e13,
                "unet_bytes": 1.0e9, "decode": 1.0e12,
                "decode_bytes": 1.0e12, "batch_flops": 4.2e13}
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_roofline_and_mfu_readers():
    rec = _record()
    least = max(4.0e13 / flops.BF16_PEAK, 1.0e9 / flops.HBM_BYTES_S)
    assert registry.reader("unet_roofline.sample")(rec) == pytest.approx(
        100 * least / 4.0)
    # the decode is bound by its bytes here
    assert registry.reader("decode_roofline.sample")(rec) == pytest.approx(
        100 * (1.0e12 / flops.HBM_BYTES_S) / 1.0)
    assert registry.reader("mfu.sample")(rec) == pytest.approx(
        100 * 4.2e13 / 32 * 64 / 8.0 / flops.BF16_PEAK)
    assert registry.reader("unet_call_ms.sample")(rec) == pytest.approx(
        1e3 * 7.0 / 42)
    assert registry.reader("device_idle.sample")(rec) == pytest.approx(46.0)
    assert registry.reader("cond_ms.sample")(rec) == pytest.approx(1e3)


def test_readers_find_nothing_outside_their_cells():
    rec = _record(trace=None, work={})
    for name in ("unet_roofline.sample", "mfu.sample", "device_idle.sample",
                 "optim_ms.train", "train_img_s", "mfu.train"):
        assert registry.reader(name)(rec) is None
    rec.kind, rec.images = "train", 0
    assert registry.reader("train_img_s")(rec) is None
    assert not math.isnan(registry.reader("setup_s")(
        common.Record(kind="train", setup_s=3.0)))
