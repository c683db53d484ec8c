"""Step watchdog: hang detection for training loops and the serving
engine. Counterpart: ``paddle_tpu/distributed/watchdog.py``.

A daemon thread watches two signals:
- step progress: a loop calling ``notify_step`` (or an engine wrapped by
  ``watch_engine``) bumps a heartbeat; no bump for ``timeout`` seconds
  gives a hang report;
- active sections: ``watch_section(name)`` wraps a blocking call; a
  section still active past its deadline is reported with its name and
  age.

A hang report holds the last completed step, the stuck and active
sections, the device state (``torch.cuda``: device, memory allocated
and reserved, the current stream), any extra section the caller adds
(``watch_engine``: the engine's ``debug_dump()`` and its tracer's
flight-recorder tail, with the whole trace exported beside the dump
file) and every Python thread's stack; it goes to stderr, to
``dump_path`` when given, and to ``on_hang``. The JAX package reads its
defaults from flags; the port has none, so they are the constants
below.
"""
from __future__ import annotations

import io
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

__all__ = ["StepWatchdog", "watch_section", "watch_engine",
           "get_default_watchdog", "enable_watchdog", "notify_step"]

# seconds without step progress (or section completion) before a report
DEFAULT_TIMEOUT_S = 300.0
# where reports are appended by default (None: stderr and on_hang only)
DEFAULT_DUMP_PATH: Optional[str] = None


class StepWatchdog:
    """Daemon monitor thread. Thread-safe; one instance can watch the
    whole process."""

    def __init__(self, timeout: Optional[float] = None,
                 poll_interval: float = 1.0,
                 on_hang: Optional[Callable[[str], None]] = None,
                 dump_path: Optional[str] = None,
                 extra_dump: Optional[Callable[[io.StringIO],
                                              None]] = None):
        self.timeout = float(timeout if timeout is not None
                             else DEFAULT_TIMEOUT_S)
        self.poll_interval = poll_interval
        self.on_hang = on_hang
        self.dump_path = dump_path or DEFAULT_DUMP_PATH
        # an optional section of the report (watch_engine adds the
        # engine's scheduler state and flight recorder)
        self.extra_dump = extra_dump
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._step = 0
        self._sections: Dict[int, tuple] = {}   # id -> (name, start, ddl)
        self._next_sid = 0
        self._reported = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --
    def start(self):
        if self._thread is not None:
            return self
        self._stop = threading.Event()   # fresh event: stop() poisons it
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="paddle_tpu_torch-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_interval)
            self._thread = None

    # -- signals --
    def notify_step(self, step: Optional[int] = None):
        with self._lock:
            self._step = self._step + 1 if step is None else step
            self._last_beat = time.monotonic()
            self._reported = False

    def section(self, name: str, timeout: Optional[float] = None):
        return _Section(self, name, timeout or self.timeout)

    def _begin(self, name, timeout):
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            now = time.monotonic()
            self._sections[sid] = (name, now, now + timeout)
        return sid

    def _end(self, sid):
        with self._lock:
            self._sections.pop(sid, None)
            self._last_beat = time.monotonic()
            self._reported = False

    # -- monitor --
    def _run(self):
        while not self._stop.wait(self.poll_interval):
            now = time.monotonic()
            with self._lock:
                expired = [(n, now - t0) for (n, t0, ddl)
                           in self._sections.values() if now > ddl]
                stalled = (now - self._last_beat) > self.timeout
                reported = self._reported
            if (expired or stalled) and not reported:
                self._report(expired, now)
                with self._lock:
                    self._reported = True

    def _report(self, expired: List[tuple], now: float):
        buf = io.StringIO()
        buf.write("\n========== paddle_tpu_torch WATCHDOG: hang detected "
                  "==========\n")
        with self._lock:
            buf.write(f"last completed step: {self._step}; "
                      f"{now - self._last_beat:.1f}s since last "
                      f"progress (timeout {self.timeout:.1f}s)\n")
            active = list(self._sections.values())
        for name, age in expired:
            buf.write(f"  STUCK section: {name!r} running {age:.1f}s\n")
        for name, t0, _ in active:
            buf.write(f"  active section: {name!r} ({now - t0:.1f}s)\n")
        self._dump_env(buf)
        if self.extra_dump is not None:
            try:
                self.extra_dump(buf)
            except Exception as e:           # noqa: BLE001
                buf.write(f"(extra dump failed: {e})\n")
        buf.write("---- python thread stacks ----\n")
        frames = sys._current_frames()
        for tid, frame in frames.items():
            tname = next((t.name for t in threading.enumerate()
                          if t.ident == tid), str(tid))
            buf.write(f"-- thread {tname} --\n")
            buf.write("".join(traceback.format_stack(frame)))
        buf.write("====================================================\n")
        text = buf.getvalue()
        sys.stderr.write(text)
        sys.stderr.flush()
        if self.dump_path:
            try:
                with open(self.dump_path, "a") as f:
                    f.write(text)
            except OSError:
                pass
        if self.on_hang is not None:
            try:
                self.on_hang(text)
            except Exception:                # noqa: BLE001
                pass

    def _dump_env(self, buf):
        """The device section: torch.cuda's view of the current device.
        Read only on a hang, from the monitor thread (a CUDA call from
        another thread would spoil a graph capture in progress, so the
        healthy path never makes one)."""
        buf.write("---- device state ----\n")
        try:
            import torch
            if torch.cuda.is_available():
                dev = torch.cuda.current_device()
                buf.write(
                    f"cuda device {dev} ({torch.cuda.get_device_name(dev)})"
                    f" of {torch.cuda.device_count()}; memory allocated="
                    f"{torch.cuda.memory_allocated(dev)} reserved="
                    f"{torch.cuda.memory_reserved(dev)} max_allocated="
                    f"{torch.cuda.max_memory_allocated(dev)}; current "
                    f"stream={torch.cuda.current_stream(dev)}\n")
            else:
                buf.write(f"no cuda device; torch {torch.__version__}, "
                          f"{torch.get_num_threads()} cpu threads\n")
        except Exception as e:               # noqa: BLE001
            buf.write(f"(torch state unavailable: {e})\n")
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            if k in os.environ:
                buf.write(f"{k}={os.environ[k]}\n")


class _Section:
    def __init__(self, wd: StepWatchdog, name: str, timeout: float):
        self._wd = wd
        self._name = name
        self._timeout = timeout
        self._sid = None

    def __enter__(self):
        self._sid = self._wd._begin(self._name, self._timeout)
        return self

    def __exit__(self, *exc):
        self._wd._end(self._sid)
        return False


_default: Optional[StepWatchdog] = None
_default_lock = threading.Lock()


def get_default_watchdog(create: bool = False) -> Optional[StepWatchdog]:
    global _default
    with _default_lock:
        if _default is None and create:
            _default = StepWatchdog().start()
        return _default


def enable_watchdog(timeout: Optional[float] = None, **kw) -> StepWatchdog:
    """Start (or return) the process-wide watchdog."""
    global _default
    with _default_lock:
        if _default is None:
            _default = StepWatchdog(timeout=timeout, **kw).start()
        return _default


def notify_step(step: Optional[int] = None):
    wd = get_default_watchdog()
    if wd is not None:
        wd.notify_step(step)


def watch_engine(engine, timeout: Optional[float] = None,
                 poll_interval: float = 1.0,
                 on_hang: Optional[Callable[[str], None]] = None,
                 dump_path: Optional[str] = None) -> StepWatchdog:
    """Watch a ServingEngine's ``step()``: each step runs inside a
    watched section (a step that never returns is reported with its age)
    and bumps the heartbeat when it completes, so an engine stuck inside
    a step and an engine no longer stepped both trip after ``timeout``
    seconds. The report adds the engine's ``debug_dump()`` and, with a
    tracer attached, its flight-recorder tail (``summary()``); with a
    ``dump_path`` the whole trace is exported to
    ``dump_path + ".trace.json"``. Returns the started watchdog
    (``stop()`` detaches it; the step wrapper stays, inert)."""

    def _dump(buf: io.StringIO):
        buf.write(engine.debug_dump())
        tracer = getattr(engine, "tracer", None)
        if tracer is not None:
            buf.write(tracer.summary())
            if dump_path:
                try:
                    p = tracer.export(dump_path + ".trace.json")
                    buf.write(f"flight recorder exported: {p}\n")
                except Exception as e:     # noqa: BLE001 -- the report
                    # must survive a failed export
                    buf.write(f"(flight recorder export failed: {e})\n")

    wd = StepWatchdog(timeout=timeout, poll_interval=poll_interval,
                      on_hang=on_hang, dump_path=dump_path,
                      extra_dump=_dump)
    inner = engine.step

    def step():
        with wd.section("ServingEngine.step"):
            out = inner()
        wd.notify_step()
        return out

    engine.step = step
    engine._step_watchdog = wd
    return wd.start()


def watch_section(name: str, timeout: Optional[float] = None):
    """Context manager marking a blocking call the watchdog should report
    if it never completes. A no-op when the watchdog is not running."""
    wd = get_default_watchdog()
    if wd is None:
        class _Null:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False
        return _Null()
    return wd.section(name, timeout)
