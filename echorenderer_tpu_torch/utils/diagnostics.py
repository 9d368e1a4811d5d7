"""Diagnostics (counterpart of echorenderer_tpu/utils/diagnostics.py):
device-side debug assertions + structured logging.

Rebuild of the reference's diagnostics layer
(src/Echo.Core/Common/Diagnostics/Ensure.cs — DEBUG-conditional asserts —
and Loggers.cs:5-13 — pluggable named loggers). `dcheck` is the device
analogue of `Ensure.IsTrue`: it returns at once unless `ECHO_DEBUG_DEVICE`
is set and a `run_checked` is active in the calling thread
(`checks_active`); there it keeps the predicate's `all` as a device flag,
without reading the host, and `run_checked` reads every flag of its call
in one transfer afterwards.

Host-side, `ensure` mirrors Ensure.cs (active under `ECHO_DEBUG=1`), and
`get_logger` gives the structured console logger the reference's Loggers
provide.

Tracing: `span` names a range of host work (`echo.*`) for a torch
profiler, and costs one flag read while none records; `count` adds to the
process's one registry of host counters (`counts`, `reset_counts`), which
is always on and never reads the device; `host_read` does both for a
device-to-host read.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import sys
import threading
from typing import Callable

import torch

# ---------------------------------------------------------------------------
# Structured logging (reference Common/Diagnostics/Loggers.cs)
# ---------------------------------------------------------------------------

_LOG_FORMAT = "%(asctime)s.%(msecs)03d %(levelname)-7s [%(name)s] %(message)s"
_DATE_FORMAT = "%H:%M:%S"
_configured = False


def _configure_root():
    global _configured
    if _configured:
        return
    root = logging.getLogger("echo")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT, _DATE_FORMAT))
        root.addHandler(handler)
    level = os.environ.get("ECHO_LOG_LEVEL", "WARNING").upper()
    root.setLevel(getattr(logging, level, logging.WARNING))
    root.propagate = False
    _configured = True


def get_logger(component: str) -> logging.Logger:
    """Named logger under the 'echo' hierarchy; level set by
    ECHO_LOG_LEVEL (default WARNING, so production runs stay silent —
    the reference's loggers are similarly opt-in sinks)."""
    _configure_root()
    return logging.getLogger(f"echo.{component}")


def set_log_level(level: str):
    _configure_root()
    logging.getLogger("echo").setLevel(
        getattr(logging, level.upper(), logging.WARNING)
    )


def log_event(logger: logging.Logger, event: str, **fields):
    """Structured one-line event: `event key=value ...` (the reference's
    EventRow-style reporting, kept grep-able). Formats nothing unless the
    logger takes INFO."""
    if not logger.isEnabledFor(logging.INFO):
        return
    if fields:
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        logger.info("%s %s", event, kv)
    else:
        logger.info("%s", event)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v


# ---------------------------------------------------------------------------
# Tracing: spans on the profiler's clock, host counters
# ---------------------------------------------------------------------------


NO_SPAN = contextlib.nullcontext()  # what `span` returns while no profiler records
_profiler_enabled = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str, args: str | None = None):
    """A named range of host work. While a torch profiler records it is a
    profiler range of that name, which kineto stamps on the clock of the
    card's kernels and copies, so a trace reader can name the card's idle
    gaps by the innermost span open in them; otherwise the shared no-op
    `NO_SPAN`. `name` is a constant `echo.*` string that readers match on;
    variable detail (a layer, a read site) goes in `args`, kept as the
    range's "args" where the profiler records inputs. Spans nest on the
    calling thread.

    The range is an op's (`_RecordFunctionFast`), not a user annotation's
    (`torch.profiler.record_function`): kineto mirrors each annotation as a
    range on the device's timeline, which a reader that sorts device
    events by type can take for a kernel (the card's torch reports no
    activity type), and which drops `args` besides."""
    if _profiler_enabled():
        return _RecordFunctionFast(name, (), {"args": args}) if args else _RecordFunctionFast(name)
    return NO_SPAN


_counts: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()


def count(name: str, k: int = 1):
    """Add `k` to the host counter `name` (`reads.<site>`, `launches.<kernel
    form>`, `rays.trace`, ...). Always on, with or without a profiler."""
    with _counts_lock:
        _counts[name] += k


def counts() -> collections.Counter:
    """A snapshot of every counter of the process, {name: count}; a name
    that never moved reads 0."""
    with _counts_lock:
        return collections.Counter(_counts)


def counts_since(before: dict) -> dict:
    """The counters that moved since the snapshot `before`, by how much."""
    now = counts()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def reset_counts():
    """Zero every counter."""
    with _counts_lock:
        _counts.clear()


def host_read(site: str):
    """A device-to-host read at `site`: counts `reads.<site>` and returns
    the `echo.read` span, with the site as its args, to hold the read."""
    count("reads." + site)
    return span("echo.read", site)


# ---------------------------------------------------------------------------
# Host asserts (reference Ensure.cs — compiled away outside DEBUG)
# ---------------------------------------------------------------------------


def debug_enabled() -> bool:
    return bool(os.environ.get("ECHO_DEBUG"))


def ensure(condition: bool, message: str = "ensure failed"):
    """Host-side invariant check, active under ECHO_DEBUG=1 (the analogue
    of Ensure.IsTrue, Ensure.cs — a no-op in release builds)."""
    if debug_enabled() and not condition:
        raise AssertionError(message)


# ---------------------------------------------------------------------------
# Device asserts — Ensure.cs for device code
# ---------------------------------------------------------------------------


def device_checks_enabled() -> bool:
    return bool(os.environ.get("ECHO_DEBUG_DEVICE"))


class _Checks(threading.local):
    flags: list | None = None  # the active run_checked's (flag, message, fmt)


_checks = _Checks()


def checks_active() -> bool:
    """True while ECHO_DEBUG_DEVICE=1 and a `run_checked` is active in this
    thread: callers whose predicates cost launches build them only then."""
    return _checks.flags is not None and device_checks_enabled()


def dcheck(pred, message: str, **fmt_kwargs):
    """Device-side assertion: no-op unless `checks_active()`. There it
    appends `torch.all(pred)` (a device flag, no host read) for
    `run_checked` to read. Off, dcheck touches nothing, but an eager caller
    has already computed `pred`: guard a costly one with `checks_active()`."""
    if not checks_active():
        return
    _checks.flags.append((torch.all(pred), message, fmt_kwargs))


def run_checked(fn: Callable, *args, **kwargs):
    """Run `fn(*args, **kwargs)` collecting its dchecks, then read every
    flag in one host transfer and raise on the first that failed, with its
    message (formatted with its keyword values). Use for debug renders:
    e.g. `run_checked(_sample_frame, ...)`."""
    outer = _checks.flags
    _checks.flags = []
    try:
        out = fn(*args, **kwargs)
        checks = _checks.flags
    finally:
        _checks.flags = outer
    if checks:
        dev = checks[0][0].device
        passed = torch.stack([flag.to(dev) for flag, _, _ in checks]).tolist()
        for ok, (_, message, fmt) in zip(passed, checks):
            if not ok:
                values = {k: v.tolist() if isinstance(v, torch.Tensor) else v
                          for k, v in fmt.items()}
                raise AssertionError(message.format(**values))
    return out
