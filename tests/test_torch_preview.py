"""PyTorch port: the live preview (ui/preview.py) and the render loop's
progress hooks (processes/render.py), on the CPU.

- The server's endpoints and the dashboard's areas, as tests/test_preview.py
  holds the JAX package's; the PNG it serves is the JAX encoder's bytes.
- `progress` in its keyword form (layer=, samples=, image=, tile_batch=,
  as far as the callback names them) and in the three-argument form; a
  TypeError raised inside a callback propagates (no retry).
- `tile_progress`: the first epoch as spiral tile batches, partial frames
  filling in, the layer bitwise equal to the untiled render, for a fixed
  and an adaptive profile; the preview's callback publishes them.
- terminal.watch_file.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.processes.render import EvaluationProfile, render, render_layer
from echorenderer_tpu_torch.scene.prepare import prepare_scene
from echorenderer_tpu_torch.ui.preview import PreviewServer, PreviewState, preview_progress

torch.set_num_threads(1)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture(scope="module")
def cornell():
    return prepare_scene(scenes.cornell_box(), device="cpu")


def test_endpoints():
    from echorenderer_tpu.io.images import encode_png as jencode

    state = PreviewState()
    server = PreviewServer(state).start()
    try:
        code, ctype, body = _get(server.port, "/")
        assert code == 200 and "text/html" in ctype and b"echorenderer-tpu" in body
        assert _get(server.port, "/frame.png")[0] == 404  # no frame yet
        state.publish_status(epoch=2, noise=0.1)
        status = json.loads(_get(server.port, "/status.json")[2])
        assert status["epoch"] == 2 and status["noise"] == 0.1
        img = np.random.RandomState(0).uniform(0, 2, (8, 8, 3)).astype(np.float32)
        state.publish_frame(img)
        code, ctype, body = _get(server.port, "/frame.png")
        assert code == 200 and ctype == "image/png"
        assert body == jencode(img / (1.0 + img))
        assert _get(server.port, "/nope")[0] == 404
    finally:
        server.stop()


def test_dashboard_areas():
    """The four EchoUI areas: per-layer viewer with an exact pixel
    inspector, statistics, operations, logs."""
    import logging

    state = PreviewState()
    server = PreviewServer(state).start()
    try:
        rs = np.random.RandomState(1)
        main = rs.uniform(0, 2, (6, 8, 3)).astype(np.float32)
        albedo = rs.uniform(0, 1, (6, 8, 3)).astype(np.float32)
        state.publish_frame(main)
        state.publish_frame(albedo, layer="albedo")
        assert json.loads(_get(server.port, "/layers.json")[2]) == {
            "main": [6, 8, 3], "albedo": [6, 8, 3]}
        code, ctype, _ = _get(server.port, "/frame.png?layer=albedo")
        assert code == 200 and ctype == "image/png"
        px = json.loads(_get(server.port, "/pixel.json?layer=albedo&x=3&y=1")[2])
        assert px["ok"] and px["rgb"] == [float(v) for v in albedo[4, 3]]
        assert not json.loads(_get(server.port, "/pixel.json?layer=albedo&x=99&y=0")[2])["ok"]
        assert not json.loads(_get(server.port, "/pixel.json?x=a")[2])["ok"]

        state.publish_stats({"Ray/Traced": 1234, "Sample/Completed": 99})
        st = json.loads(_get(server.port, "/stats.json")[2])
        assert st["Ray/Traced"] == 1234 and st["Sample/Completed"] == 99

        state.publish_operation("main", epoch="1/4", samples=100)
        state.publish_operation("main", epoch="2/4", samples=200)
        state.publish_operation("albedo", state="done")
        ops = json.loads(_get(server.port, "/operations.json")[2])
        assert [o["operation"] for o in ops] == ["main", "albedo"]
        assert ops[0]["epoch"] == "2/4" and ops[0]["samples"] == 200

        logging.getLogger("echo.test").warning("warn %d", 7)
        logs = json.loads(_get(server.port, "/logs.json")[2])
        assert any(l["msg"] == "warn 7" and l["level"] == "WARNING" for l in logs)
        body = _get(server.port, "/")[2]
        for area in (b"operations", b"statistics", b"logs", b"layer"):
            assert area in body
    finally:
        server.stop()


PROF = EvaluationProfile(evaluator="path", samples_per_epoch=2, min_epoch=2, max_epoch=2,
                         noise_threshold=0.0, bounce_limit=3)


def test_progress_forms(cornell):
    """Keyword callbacks get the keywords they name (an image each epoch on
    the CPU); a three-argument callback gets three; a TypeError inside a
    callback is not swallowed or retried."""
    full, partial, three = [], [], []

    def kw_cb(epoch, max_epoch, noise, **kw):
        full.append((epoch, sorted(kw), kw["samples"], kw["image"].shape, kw["layer"]))

    def named_cb(epoch, max_epoch, noise, layer="main", samples=0):
        partial.append((epoch, layer, samples))

    render_layer(cornell, PROF, (12, 8), progress=kw_cb)
    render_layer(cornell, PROF, (12, 8), progress=named_cb)
    render_layer(cornell, PROF, (12, 8), progress=lambda e, m, n: three.append((e, m)))
    assert full == [(1, ["image", "layer", "samples"], 192, (8, 12, 3), "main"),
                    (2, ["image", "layer", "samples"], 384, (8, 12, 3), "main")]
    assert partial == [(1, "main", 192), (2, "main", 384)]
    assert three == [(1, 2), (2, 2)]
    calls = []

    def broken(epoch, max_epoch, noise, layer="main"):
        calls.append(epoch)
        raise TypeError("inside the callback")

    with pytest.raises(TypeError, match="inside the callback"):
        render_layer(cornell, PROF, (12, 8), progress=broken)
    assert calls == [1]


@pytest.mark.parametrize("adaptive", [False, True])
def test_tile_progressive_bitwise_identical_and_fills_in(cornell, adaptive):
    """tile_progress renders epoch 0 as spiral tile batches: partial frames
    stream through the callback, the image is bitwise the untiled one."""
    prof = EvaluationProfile(evaluator="path", samples_per_epoch=4, min_epoch=1,
                             max_epoch=3 if adaptive else 1, bounce_limit=3, adaptive=adaptive)
    partials = []

    def cb(epoch, max_epoch, noise, layer="main", samples=0, image=None, **kw):
        if "tile_batch" in kw and image is not None:
            partials.append((kw["tile_batch"], samples, image.copy()))

    img_tiled, info_t = render_layer(cornell, prof, (80, 40), seed=5, progress=cb,
                                     tile_progress=4)
    img_plain, info_p = render_layer(cornell, prof, (80, 40), seed=5)
    assert img_tiled.tobytes() == img_plain.tobytes()
    assert (info_t["samples"], info_t["epochs"]) == (info_p["samples"], info_p["epochs"])
    # 80x40 with 32px tiles = 3x2 tiles -> 4 batches of 800 pixels
    assert [b for b, _, _ in partials] == [(1, 4), (2, 4), (3, 4), (4, 4)]
    assert [s for _, s, _ in partials] == [3200, 6400, 9600, 12800]
    nz = [int((np.abs(p).sum(-1) > 0).sum()) for _, _, p in partials]
    assert nz == sorted(nz) and nz[0] < nz[-1]
    # three-argument callbacks get no tile-batch reports
    three = []
    render_layer(cornell, prof, (80, 40), seed=5, progress=lambda e, m, n: three.append(e),
                 tile_progress=4)
    assert three[0] == 1 and len(three) == info_t["epochs"]


def test_preview_progress_publishes_tiles(cornell):
    from echorenderer_tpu_torch.processes.render import RenderProfile

    state = PreviewState()
    server = PreviewServer(state).start()
    try:
        cb = preview_progress(state, cornell, None)
        prof = RenderProfile(resolution=(40, 40), evaluations=(PROF,))
        out = render(cornell, prof, progress=cb, tile_progress=16)
        status = json.loads(_get(server.port, "/status.json")[2])
        assert status["epoch"] == 2 and status["tile_batch"] == [4, 4]
        assert status["samples"] == 2 * 2 * 1600
        code, ctype, body = _get(server.port, "/frame.png")
        assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        from echorenderer_tpu_torch.io.images import encode_png

        last = out["main"]
        assert body == encode_png(last / (1.0 + last))
    finally:
        server.stop()


def test_watch_file_triggers_on_change(tmp_path):
    """The save-to-reschedule watcher (reference SchedulerUI.cs:22-34)."""
    from echorenderer_tpu_torch.terminal import watch_file

    f = tmp_path / "scene.echo"
    f.write_text("a")
    stop, fired = threading.Event(), threading.Event()

    def on_change():
        fired.set()
        stop.set()

    t = threading.Thread(target=watch_file, args=(str(f), on_change, stop, 0.05), daemon=True)
    t.start()
    time.sleep(0.2)
    f.write_text("b")  # mtime bump
    assert fired.wait(timeout=5.0)
    t.join(timeout=2.0)
    assert not t.is_alive()
