"""The metrics' arithmetic on synthetic image times and device intervals."""

import statistics

import pytest

from echobench import manifest, run, trace

BENCH = manifest.load(run.ROOT)


def read(name, r):
    return manifest.reader(run.ROOT, name, BENCH)(r)


def _run(times, traffic=None, tr=None):
    images, t = [], 100.0
    for dt in times:
        images.append(run.Image(t, t + dt, {}))
        t += dt
    traffic = traffic or {"resolution": [10, 5], "profile": {"samples_per_epoch": 4,
                                                              "max_epoch": 2}}
    return run.Run(traffic, {"setup_s": 7.5, "prepare_s": 0.25}, images,
                   (images[0].start, images[-1].end), tr)


def test_rate_counts_every_sample_over_the_whole_window():
    r = _run([0.5, 0.25, 0.25])
    assert read("mspps", r) == pytest.approx(3 * 10 * 5 * 8 / 1.0 / 1e6)
    assert read("finished_image_s", r) == pytest.approx(1.0 / 3)
    assert read("setup_s", r) == 7.5 and read("prepare_s", r) == 0.25


def test_p95_is_the_inclusive_95th_percentile_of_all_images():
    times = [0.1] * 95 + [0.2, 0.3, 0.4, 0.5, 0.6]
    r = _run(times)
    want = statistics.quantiles([t * 1e3 for t in times], n=100, method="inclusive")[94]
    assert read("image_p95_ms", r) == pytest.approx(want)
    assert 100.0 < want < 200.0
    assert read("image_p95_ms", _run([0.1])) is None


def _iv(name, a, b, kind="kernel"):
    return trace.Interval(name, a, b, kind)


def test_idle_share_takes_the_union_of_overlapping_intervals():
    dev = [_iv("k1", 0.0, 2.0), _iv("k2", 1.0, 3.0), _iv("Memcpy HtoD", 2.5, 3.5, "gpu_memcpy"),
           _iv("k3", 6.0, 7.0), _iv("k4", 9.5, 12.0)]
    tr = trace.Trace((0.0, 10.0), dev, [], 2)
    assert tr.busy_s() == pytest.approx(3.5 + 1.0 + 0.5)
    r = _run([5.0, 5.0], tr=tr)
    assert read("device_idle_pct.frames", r) == pytest.approx(50.0)
    assert read("device_idle_pct.standard", r) == pytest.approx(50.0)
    assert trace.gaps(dev, 0.0, 10.0) == [(3.5, 6.0), (7.0, 9.5)]


def test_launches_and_kernel_times_a_traced_image():
    dev = [_iv("void mega_kernel<false, false>(Args)", 0.0, 0.1),
           _iv("void mega_kernel<false, false>(Args)", 0.2, 0.3),
           _iv("void at::native::elementwise_kernel<128, 4>", 0.3, 0.4),
           _iv("void seg_kernel<true, false, false, true>(Seg)", 0.4, 0.45),
           _iv("void select_group<8, 4, 256>(Sel)", 0.45, 0.5),
           _iv("Memset (Device)", 0.5, 0.6, "gpu_memset")]
    tr = trace.Trace((0.0, 1.0), dev, [], 2)
    r = _run([0.5, 0.5], tr=tr)
    assert read("launches_per_image", r) == pytest.approx(5 / 2)
    assert read("mega_ms_per_image", r) == pytest.approx(100.0)
    assert read("traversal_ms_per_image", r) == pytest.approx(50.0)
    none = _run([0.5, 0.5], tr=trace.Trace((0.0, 1.0), dev[2:3], [], 2))
    assert read("mega_ms_per_image", none) is None and read("traversal_ms_per_image", none) is None
    assert read("launches_per_image", _run([1.0])) is None


def test_breakdown_names_ops_and_the_host_op_of_each_gap():
    dev = [_iv("a", 0.0, 1.0), _iv("b", 3.0, 3.5), _iv("a", 4.0, 5.0)]
    host = [_iv("aten::nonzero", 0.9, 3.2, "cpu_op"), _iv("aten::item", 1.5, 2.5, "cpu_op")]
    out = trace.breakdown(trace.Trace((0.0, 5.0), dev, host, 1))
    assert out["device_ops"] == [["a", 2.0], ["b", 0.5]]
    assert out["idle_gaps"] == [["aten::item", 2.0], ["host Python", 0.5]]
