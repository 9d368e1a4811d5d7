"""Headless CLI render driver — the Echo.Terminal analogue (counterpart of
echorenderer_tpu/terminal.py).

Mirrors the reference CLI surface (Echo.Terminal/Program.cs:112-175):

    python -m echorenderer_tpu_torch.terminal -p scene.echo [-o layer=file ...]
        [-q quality] [-r WxH] [--seed N] [--scene builtin] [--profile-name x]
        [--device cuda|cpu]

Flow (Program.cs:45-87 analogue): parse .echo -> construct RenderProfile ->
prepare scene on `--device` (the card by default) -> render with console
monitor (progress %, ETA, SPPS) -> save layers (default render.png).
`-u/--utilization` is accepted for parity but ignored: the card runs every
kernel at full occupancy (there is no worker count to set).
"""

from __future__ import annotations

import argparse
import sys
import time


def _parse_outputs(pairs):
    outs = []
    for p in pairs or []:
        if "=" in p:
            layer, path = p.split("=", 1)
        else:
            layer, path = "main", p
        outs.append((layer, path))
    return outs or [("main", "render.png")]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="echorenderer-tpu-torch",
        description="GPU path tracer, the PyTorch port (Echo.Terminal-compatible CLI)",
    )
    ap.add_argument("-p", "--profile", help=".echo file with a RenderProfile")
    ap.add_argument("--profile-name", help="declaration name inside the .echo file")
    ap.add_argument("--scene", help="built-in scene: cornell_box, material_ball, many_lights, sphere_field")
    ap.add_argument("-o", "--output", action="append", help="layer=file (repeatable; default main=render.png)")
    ap.add_argument("-q", "--quality", type=float, default=None, help="quality knob for the standard profile")
    ap.add_argument("-r", "--resolution", default=None, help="WxH, e.g. 1920x1080")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--camera", default=None, help="camera name to render from")
    ap.add_argument("--device", default="cuda",
                    help="torch device the scene is prepared and rendered on (default cuda; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("-u", "--utilization", type=float, default=None,
                    help="accepted for reference parity; ignored")
    ap.add_argument("--no-compose", action="store_true", help="skip the composition stack")
    ap.add_argument("--preview", type=int, nargs="?", const=8000, default=None,
                    help="serve a live preview dashboard on this port (GUI analogue)")
    ap.add_argument("--watch", action="store_true",
                    help="with -p: re-render whenever the .echo file changes "
                         "(reference SchedulerUI save-to-reschedule)")
    ap.add_argument("--debug-device", action="store_true",
                    help="run each layer's first epoch with the device-side checks "
                         "(reference DEBUG Ensure checks); slower")
    ap.add_argument("--log-level", default=None,
                    help="echo.* logger level (DEBUG/INFO/WARNING); default "
                         "WARNING or $ECHO_LOG_LEVEL")
    return ap


def load_profile(args):
    """Resolve (scene, profile) from CLI arguments."""
    from .processes.render import RenderProfile, standard_path_traced_profile

    if args.profile:
        from .io.echo_dsl import EchoSource

        src = EchoSource(args.profile)
        if args.profile_name:
            prof = src.construct(args.profile_name)
        else:
            prof = src.construct_first(RenderProfile)
        if prof.scene is None:
            from .scene.entities import Scene

            prof.scene = src.construct_first(Scene)
    else:
        from .models import scenes as builtin

        name = args.scene or "cornell_box"
        maker = getattr(builtin, name, None)
        if maker is None:
            raise SystemExit(f"unknown built-in scene {name!r}")
        prof = standard_path_traced_profile(
            quality=args.quality if args.quality is not None else 1.0
        )
        prof.scene = maker()

    if args.resolution:
        w, h = args.resolution.lower().split("x")
        prof.resolution = (int(w), int(h))
    if args.camera:
        prof.camera_name = args.camera
    if args.seed:
        prof.seed = args.seed
    if args.no_compose:
        prof.composition = ()
    return prof


class ConsoleMonitor:
    """Progress line with percent, elapsed, ETA and SPPS — the analogue of
    ScheduledRender.Monitor (Processes/ScheduledRender.cs:189-242). It
    takes no image, so the render loop reads none back for it."""

    def __init__(self, stream=sys.stderr):
        self.stream = stream
        self.start = time.perf_counter()
        self.samples = 0

    def __call__(self, epoch, max_epoch, noise, layer="main", samples=0):
        elapsed = time.perf_counter() - self.start
        self.samples = samples or self.samples
        frac = epoch / max(max_epoch, 1)
        eta = elapsed / max(frac, 1e-6) - elapsed
        spps = self.samples / max(elapsed, 1e-9)
        self.stream.write(
            f"\r[{layer}] epoch {epoch}/{max_epoch} ({frac * 100:5.1f}%)  "
            f"noise {noise:.4f}  elapsed {elapsed:6.1f}s  eta {max(eta, 0):6.1f}s  "
            f"{spps / 1e6:6.2f} Mspps   "
        )
        self.stream.flush()

    def finish(self):
        self.stream.write("\n")
        self.stream.flush()


def watch_file(path, on_change, stop=None, poll_s: float = 0.5):
    """Re-run `on_change` whenever `path`'s mtime advances (the reference's
    save-to-reschedule loop, Areas/SchedulerUI.cs:22-34). Blocks until
    `stop` (a threading.Event) is set, or forever."""
    import os

    last = os.stat(path).st_mtime
    while stop is None or not stop.is_set():
        time.sleep(poll_s)
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            continue
        if mtime != last:
            last = mtime
            on_change()


def _prepared_summary(prepared, seconds: float) -> str:
    """One line on what prepare_scene built and which BVH builder it took."""
    from .aggregation.bvh import build_bvh

    g = prepared.geometry
    tables = (f"{prepared.prim_soa.padded} padded prims" if prepared.prim_soa is not None
              else "TLAS")
    if prepared.hier_soa is not None:
        tables += f", {prepared.hier_soa.num_chunks} chunk-tree chunks"
    if prepared.instances is not None:
        tables += f", {prepared.instances.num_instances} instances"
    builder = "C++" if build_bvh.native_calls else "numpy"
    return (f"prepared {g.num_triangles} tris, {g.num_spheres} spheres, "
            f"{prepared.lights.num_lights} lights, {prepared.tex_atlas.shape[0]} atlas "
            f"textures ({tables}) on {prepared.device} in {seconds:.2f}s; SAH builds: "
            f"{build_bvh.native_calls} C++, {build_bvh.numpy_calls} numpy (last: {builder})")


def _render_once(args, prof, state, monitor):
    """Prepare + render + save for one profile instance. Returns the info
    dict (shared by the one-shot and --watch paths)."""
    from .io import images
    from .processes.render import render
    from .scene.prepare import prepare_scene

    t0 = time.perf_counter()
    print("preparing scene...", file=sys.stderr)
    prepared = prepare_scene(prof.scene, prof.camera_name, device=args.device)
    print(_prepared_summary(prepared, time.perf_counter() - t0), file=sys.stderr)

    if state is not None:
        def progress(epoch, max_epoch, noise, layer="main", samples=0, image=None, **kw):
            monitor(epoch, max_epoch, noise, layer=layer, samples=samples)
            noise_r = round(noise, 5) if noise == noise and noise != float("inf") else None
            status = dict(layer=layer, epoch=epoch, max_epoch=max_epoch,
                          noise=noise_r, samples=samples)
            if "tile_batch" in kw:
                status["tile_batch"] = list(kw["tile_batch"])
            state.publish_status(**status)
            state.publish_operation(
                layer, epoch=f"{epoch}/{max_epoch}", samples=samples,
                noise=noise_r if noise_r is not None else "-",
            )
            if image is not None:
                state.publish_frame(image, layer=layer)
    else:
        progress = monitor
    out = render(prepared, prof, progress=progress,
                 tile_progress=16 if state is not None else 0)
    monitor.finish()

    infos = out.get("__info__", {})
    for layer, info in infos.items():
        if isinstance(info, dict) and "samples" in info:
            disp = info.get("dispatch") or {}
            print(
                f"[{layer}] {info['samples']:,} samples in {info['seconds']:.2f}s "
                f"({info['samples_per_second'] / 1e6:.2f} Mspps); dispatch: "
                f"{disp.get('integrator')} ({disp.get('integrator_reason')}), rays: "
                f"{disp.get('accelerator')}",
                file=sys.stderr,
            )
            if state is not None:
                state.publish_operation(
                    layer, state="done", seconds=round(info["seconds"], 2),
                    mspps=round(info["samples_per_second"] / 1e6, 3),
                )
                stats_row = {
                    f"{layer}/samples": info["samples"],
                    f"{layer}/Mspps": round(info["samples_per_second"] / 1e6, 3),
                }
                # which accelerator/integrator took the frame, and why
                if disp:
                    stats_row[f"{layer}/accelerator"] = disp["accelerator"]
                    stats_row[f"{layer}/integrator"] = (
                        f"{disp['integrator']} ({disp['integrator_reason']})"
                    )
                state.publish_stats(stats_row)
    if "composition_errors" in infos:
        for op, msg in infos["composition_errors"].items():
            print(f"composition {op}: {msg}", file=sys.stderr)

    for layer, path in _parse_outputs(args.output):
        if layer not in out:
            print(f"no layer {layer!r}; have {sorted(k for k in out if k != '__info__')}", file=sys.stderr)
            continue
        images.save(path, out[layer])
        print(f"saved {layer} -> {path}", file=sys.stderr)
    return infos


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import os

    if args.debug_device:
        os.environ["ECHO_DEBUG_DEVICE"] = "1"
        os.environ.setdefault("ECHO_DEBUG", "1")
    if args.log_level:
        from .utils.diagnostics import set_log_level

        set_log_level(args.log_level)

    prof = load_profile(args)
    if prof.scene is None:
        raise SystemExit("no scene: pass -p file.echo or --scene builtin")

    state = server = None
    if args.preview is not None:
        from .ui.preview import PreviewServer, PreviewState

        state = PreviewState()
        server = PreviewServer(state, host="0.0.0.0", port=args.preview).start()
        print(f"live preview: http://localhost:{server.port}/", file=sys.stderr)

    try:
        monitor = ConsoleMonitor()
        _render_once(args, prof, state, monitor)
        if args.watch and args.profile:
            print(f"watching {args.profile} (ctrl-c to stop)...", file=sys.stderr)

            def on_change():
                print(f"\n{args.profile} changed; re-rendering", file=sys.stderr)
                if state is not None:
                    state.publish_status(state="rescheduled")
                try:
                    _render_once(args, load_profile(args), state, ConsoleMonitor())
                except Exception as e:  # parse errors keep the watcher alive
                    print(f"reload failed: {e}", file=sys.stderr)

            watch_file(args.profile, on_change)
    except KeyboardInterrupt:
        pass
    finally:
        if server is not None:
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
