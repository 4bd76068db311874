"""Evaluation profiler: per-task and per-phase timings of view evaluation.

Counterpart of dask_geomodeling_tpu/runtime/profile.py (``Profiler``,
``ProgressBar``, ``record``, ``span``, ``announce_total``), the
diagnostics that dask's Profiler gives the reference.  Its device trace
is ``torch_trace``, which wraps ``torch.profiler`` where the JAX package
wraps ``jax.profiler``.

Usage::

    from dask_geomodeling_tpu_torch.runtime.profile import Profiler

    with Profiler() as prof:
        view.get_data(**request)
    print(prof.summary())          # per-function aggregate table
    prof.to_chrome_trace("t.json") # load in chrome://tracing / Perfetto

Events are recorded by hooks in the host schedulers (core/scheduler.py:
one "task" event per node, which is what the host routes of ``get_data``
run), the torch executor
(runtime/executor.py: a "task" event per host node, a "device" event per
twin, whose time is its launches', and a "transfer" event for the copy
of the result to the host) and the tile runtime (runtime/tiles.py: the
planning span, one "tile_batch" event per batch and a span per batch
phase).  With no profiler active each hook is one falsy check.
"""
import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

__all__ = ["Profiler", "ProgressBar", "torch_trace", "record", "span",
           "announce_total", "active", "active_profiler"]

_state = threading.local()

# scheduler pool workers are separate threads: fall back to the process-wide
# registration (set by whichever thread entered the context manager)
_global = {"profiler": None, "progress": None}


def _current(kind):
    local = getattr(_state, kind, None)
    return local if local is not None else _global[kind]


def active_profiler():
    """The Profiler active in this thread or process (or None)."""
    return _current("profiler")


def active():
    """True when a Profiler or ProgressBar is active."""
    return _current("profiler") is not None or _current("progress") is not None


def record(name, category, duration, t0=None, meta=None):
    """Record a completed event if a profiler is active (hook entry point)."""
    profiler = _current("profiler")
    if profiler is not None:
        profiler._record(name, category, duration, t0, meta)
    bar = _current("progress")
    if bar is not None and category in ("task", "tiles"):
        bar._advance(name)


def announce_total(n):
    """Tell an active ProgressBar how many units of work are planned."""
    bar = _current("progress")
    if bar is not None:
        bar._add_total(n)


@contextmanager
def span(name, category, meta=None):
    """Context manager recording one event around a code region."""
    profiler = _current("profiler")
    if profiler is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        profiler._record(name, category, time.perf_counter() - t0, t0, meta)


class Profiler:
    """Collects timed events during view evaluation.

    Attributes:
      events (list of dict): name, category, start (s, perf_counter),
        duration (s), thread, meta
    """

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()
        self._t_enter = None
        self._t_exit = None

    # --- context manager ---

    def __enter__(self):
        if getattr(_state, "profiler", None) is not None:
            raise RuntimeError("A Profiler is already active in this thread")
        _state.profiler = self
        _global["profiler"] = self
        self._t_enter = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._t_exit = time.perf_counter()
        _state.profiler = None
        if _global["profiler"] is self:
            _global["profiler"] = None
        return False

    # --- recording ---

    def _record(self, name, category, duration, t0=None, meta=None):
        event = {
            "name": name,
            "category": category,
            "start": t0 if t0 is not None else time.perf_counter() - duration,
            "duration": duration,
            "thread": threading.get_ident(),
        }
        if meta:
            event["meta"] = meta
        with self._lock:
            self.events.append(event)

    # --- reporting ---

    @property
    def total(self):
        """Wall-clock seconds between __enter__ and __exit__ (so far)."""
        end = self._t_exit if self._t_exit is not None else time.perf_counter()
        return end - self._t_enter if self._t_enter is not None else 0.0

    def aggregate(self):
        """{(category, name): {"count", "total", "max"}} over all events."""
        table = defaultdict(lambda: {"count": 0, "total": 0.0, "max": 0.0})
        with self._lock:
            for event in self.events:
                entry = table[(event["category"], event["name"])]
                entry["count"] += 1
                entry["total"] += event["duration"]
                entry["max"] = max(entry["max"], event["duration"])
        return dict(table)

    def summary(self):
        """A formatted per-function table, heaviest first."""
        rows = sorted(self.aggregate().items(), key=lambda kv: -kv[1]["total"])
        lines = ["%-12s %-44s %6s %10s %10s" % ("category", "name", "count", "total_ms", "max_ms")]
        for (category, name), entry in rows:
            lines.append("%-12s %-44s %6d %10.2f %10.2f" % (
                category, name[:44], entry["count"], entry["total"] * 1000, entry["max"] * 1000))
        lines.append("wall clock: %.2f ms" % (self.total * 1000))
        return "\n".join(lines)

    def to_chrome_trace(self, path):
        """Write events as a Chrome/Perfetto trace-event JSON file."""
        t0 = self._t_enter or 0.0
        trace = [
            {
                "name": event["name"],
                "cat": event["category"],
                "ph": "X",
                "ts": (event["start"] - t0) * 1e6,
                "dur": event["duration"] * 1e6,
                "pid": 0,
                "tid": event["thread"],
                "args": event.get("meta") or {},
            }
            for event in self.events
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": trace}, f)


class ProgressBar:
    """A terminal progress bar over view evaluation, the
    dask.diagnostics.ProgressBar counterpart::

        with ProgressBar():
            view.get_data(**request)

    The host schedulers and the torch executor announce their task count
    and report each host task; the tile runtime announces its batches
    and reports each.  Output goes to ``stream`` (default stderr);
    ``minimum`` suppresses output for evaluations shorter than that many
    seconds.
    """

    def __init__(self, stream=None, width=40, minimum=0.0):
        import sys

        self.stream = stream if stream is not None else sys.stderr
        self.width = width
        self.minimum = minimum
        self.total = 0
        self.done = 0
        self._t0 = None
        self._drawn = False
        self._lock = threading.Lock()

    def __enter__(self):
        if getattr(_state, "progress", None) is not None:
            raise RuntimeError("A ProgressBar is already active in this thread")
        _state.progress = self
        _global["progress"] = self
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _state.progress = None
        if _global["progress"] is self:
            _global["progress"] = None
        if self._drawn:
            self._draw(final=True)
            self.stream.write("\n")
            self.stream.flush()
        return False

    def _add_total(self, n):
        with self._lock:
            self.total += n

    def _advance(self, name):
        with self._lock:
            self.done += 1
        if time.perf_counter() - self._t0 >= self.minimum:
            self._draw()

    def _draw(self, final=False):
        elapsed = time.perf_counter() - self._t0
        total = max(self.total, self.done)
        if total:
            frac = min(self.done / total, 1.0)
            filled = int(self.width * frac)
            bar = "#" * filled + "-" * (self.width - filled)
            line = "\r[%s] %d/%d (%3.0f%%) %.1fs" % (bar, self.done, total, frac * 100, elapsed)
        else:
            line = "\r%d tasks %.1fs" % (self.done, elapsed)
        self.stream.write(line)
        self.stream.flush()
        self._drawn = True


@contextmanager
def torch_trace(log_dir):
    """Trace the block with ``torch.profiler`` (the host's operators and,
    where a card is present, its kernels and copies) and write a Chrome
    trace to ``log_dir``/trace.json (chrome://tracing, Perfetto).  Yields
    the ``torch.profiler.profile`` object, whose ``key_averages()`` sum
    the device time.  It never runs untraced: a profiler that cannot
    start, or a trace that comes out empty, raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(str(log_dir), "trace.json")
    prof.export_chrome_trace(path)
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise RuntimeError("torch.profiler wrote no trace to %s" % path)
