"""spans.py's arithmetic, and the metrics that read the port's spans and
counters, on hand-built traces and infos."""

import pytest

from echobench import manifest, run, spans, trace

BENCH = manifest.load(run.ROOT)


def read(name, r):
    return manifest.reader(run.ROOT, name, BENCH)(r)


def _iv(name, a, b, kind="cpu"):
    return trace.Interval(name, a, b, kind)


def _run(tr=None, infos=({},)):
    images = [run.Image(10.0 + i, 11.0 + i, info) for i, info in enumerate(infos)]
    return run.Run({}, {"setup_s": 1.0, "prepare_s": 0.1}, images,
                   (images[0].start, images[-1].end), tr)


# the window is [0, 10]; the spans nest as on the port's render thread, and
# some cross the window's edges
HOST = [
    _iv("echo.render_layer", -1.0, 9.0),
    _iv("echo.lane_order", -0.5, 1.0),  # starts before the window
    _iv("echo.wavefront", 1.0, 8.0),
    _iv("echo.wavefront.step", 1.0, 4.0),
    _iv("echo.trace", 1.5, 2.5),
    _iv("aten::add", 1.6, 1.7),  # a host op, not a span of the port
    _iv("echo.occlude", 3.0, 3.5),
    _iv("echo.wavefront.step", 4.0, 8.0),
    _iv("echo.trace", 5.0, 6.0),
    _iv("echo.read", 7.0, 7.8),
    _iv("echo.lane_order", 9.5, 11.0),  # ends after the window, outside the layer
]
DEVICE = [_iv("k", 0.0, 0.5, "kernel"), _iv("k", 2.0, 2.2, "kernel"),
          _iv("Memcpy DtoH", 7.6, 7.8, "gpu_memcpy"), _iv("k", 9.0, 9.2, "kernel")]


def _trace(images=2):
    return trace.Trace((0.0, 10.0), DEVICE, HOST, images)


def test_union_clips_to_the_window_and_counts_overlaps_once():
    tr = _trace()
    assert spans.union_s(tr, ["echo.lane_order"]) == pytest.approx(1.0 + 0.5)
    assert spans.union_s(tr, ["echo.trace", "echo.occlude"]) == pytest.approx(1.0 + 0.5 + 1.0)
    assert spans.union_s(tr, ["echo.render_layer", "echo.wavefront"]) == pytest.approx(9.0)
    assert spans.union_s(tr, ["echo.none"]) == 0.0
    assert spans.ms_per_image(tr, 1.5) == pytest.approx(750.0)
    assert spans.ms_per_image(tr, 0.0) is None


def test_self_time_leaves_out_what_the_children_cover():
    tr = _trace()
    steps = spans.self_s(tr, ["echo.wavefront.step"], ["echo.trace", "echo.occlude"])
    assert steps == pytest.approx(7.0 - 2.5)
    # children outside the parents take nothing from them
    assert spans.self_s(tr, ["echo.read"], ["echo.lane_order"]) == pytest.approx(0.8)


def test_idle_goes_to_the_innermost_span_at_each_gaps_middle():
    """Gaps: (0.5, 2) mid 1.25 in the first step (its trace starts at 1.5);
    (2.2, 7.6) mid 4.9 in the second step; (7.8, 9) mid 8.4 in the layer
    alone; (9.2, 10) mid 9.6 in the lane order outside the layer."""
    idle = spans.idle_by_span(_trace())
    assert idle == pytest.approx({"echo.wavefront.step": 1.5 + 5.4, "echo.render_layer": 1.2,
                                  "echo.lane_order": 0.8})
    assert spans.named_share(idle) == pytest.approx((1.5 + 5.4 + 0.8) / 8.9)


def test_idle_inside_given_intervals_and_gaps_with_no_span():
    """Without the lane order's spans, clipped to [1, 3] and [8.5, 9.6]:
    (1, 2) mid 1.5 where the trace starts, (2.2, 3) mid 2.6 in the step,
    (8.5, 9) mid 8.75 in the layer, (9.2, 9.6) mid 9.4 where no span is
    open."""
    host = [iv for iv in HOST if iv.name != "echo.lane_order"]
    tr = trace.Trace((0.0, 10.0), DEVICE, host, 1)
    idle = spans.idle_by_span(tr, within=[(8.5, 9.6), (1.0, 3.0)])
    assert idle == pytest.approx({"echo.trace": 1.0, "echo.wavefront.step": 0.8,
                                  "echo.render_layer": 0.5, None: 0.4})
    assert spans.named_share(idle) == pytest.approx(1.8 / 2.7)
    assert spans.named_share({}) is None


def test_span_metrics_read_the_ports_spans():
    tr = _trace()
    r = _run(tr)
    assert read("dispatch_host_ms_per_image", r) == pytest.approx(750.0)
    assert read("traverse_span_ms_per_image", r) == pytest.approx(1250.0)
    assert read("wavefront_self_ms_per_image", r) == pytest.approx(2250.0)
    compose = trace.Trace((0.0, 10.0), DEVICE, [_iv("echo.compose", 2.0, 2.5),
                                                _iv("echo.compose.Bloom", 2.1, 2.2),
                                                _iv("echo.compose", 6.0, 6.25)], 2)
    assert read("stack_ms_per_image", _run(compose)) == pytest.approx(375.0)


def test_span_metrics_read_nothing_where_the_program_has_no_spans():
    """A program without the spans (an older commit): no value, no error."""
    bare = trace.Trace((0.0, 10.0), DEVICE, [_iv("aten::add", 1.0, 2.0)], 2)
    for name in ("dispatch_host_ms_per_image", "traverse_span_ms_per_image",
                 "wavefront_self_ms_per_image", "stack_ms_per_image"):
        assert read(name, _run(bare)) is None
        assert read(name, _run(None)) is None


def test_host_reads_sum_every_layers_and_the_stacks_counters():
    frames = [{"main": {"counters": {"reads.binned_any": 40, "reads.layer_image": 1,
                                     "launches.binned_seg": 7}}},
              {"main": {"counters": {"reads.binned_any": 20, "reads.layer_image": 1}}}]
    assert read("host_reads_per_image.frames", _run(infos=frames)) == pytest.approx(31.0)
    standard = [{"albedo": {"counters": {"reads.layer_image": 1}},
                 "main": {"counters": {"reads.adaptive_stats": 5, "reads.layer_image": 1}},
                 "composition": {"seconds": 0.1, "counters": {"reads.compose_download": 4}},
                 "composition_errors": {"Bloom": "failed"}}]
    assert read("host_reads_per_image.standard", _run(infos=standard)) == pytest.approx(11.0)
    older = [{"main": {"seconds": 1.0, "epochs": 1}}]
    assert read("host_reads_per_image.frames", _run(infos=older)) is None


def test_capture_runs_a_traced_cell_through_the_harness():
    """`python3 -m echobench.spans`'s capture on the CPU, on a tiny mix of a
    benchmark cell: the harness's traced run goes through, the images'
    intervals and seconds are caught, the idle time inside the traced image
    falls under the port's spans, and the harness's functions are put back."""
    import dataclasses

    cell = manifest.cell(run.ROOT, "field80.image256", BENCH)
    cell = dataclasses.replace(
        cell,
        traffic={"entry": "render_layer", "loop": "closed", "clients": 1, "resolution": [16, 8],
                 "trace_images": 1,
                 "profile": {"evaluator": "path", "samples_per_epoch": 2, "min_epoch": 1,
                             "max_epoch": 1, "adaptive": False, "bounce_limit": 3,
                             "survivability": 2.5}},
        check={"layer": "main", "pixels_per_image": 16, "off_tol": 0.01,
               "limits": {"rel_err": 1e-3, "off_share": 0.05}})
    from_kineto, window = trace.from_kineto, run.window
    out = spans.capture(cell, 2**33 + 11, 0.3, "cpu", run.ROOT, BENCH)
    assert (trace.from_kineto, run.window) == (from_kineto, window)
    assert out["workload"] == "field80.image256" and out["correct"]
    assert len(out["image_s"]["traced"]) == 1 and out["traced_images"] == 1
    assert out["metrics"]["dispatch_host_ms_per_image"] > 0 and "mspps" in out["metrics"]
    # the CPU run has no device events: the traced image is one idle gap
    assert 0 < out["idle_in_images_s"] <= out["window_s"]
    assert all(name.startswith(spans.PREFIX) for name, _ in out["idle_by_span"])
