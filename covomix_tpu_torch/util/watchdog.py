"""Training hang detection (the port's copy of covomix_tpu/util/watchdog.py):
a heartbeat thread that reports when no step completes within a timeout.

The default action prints a message with the last completed step and sets
`.fired` for the caller to poll; sending SIGTERM to the process is opt-in
(kill=True). No exception is raised into the main thread: a hung device call
would never see it."""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional


class Watchdog:
    def __init__(self, timeout_s: float = 600.0, kill: bool = False, name: str = "train"):
        self.timeout_s = timeout_s
        self.kill = kill
        self.name = name
        self._last_beat = time.monotonic()
        self._last_step: Optional[int] = None
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    def beat(self, step: Optional[int] = None) -> None:
        """Call once per completed train step."""
        self._last_beat = time.monotonic()
        self._last_step = step

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 30.0)):
            idle = time.monotonic() - self._last_beat
            if idle > self.timeout_s:
                self._fired = True
                print(f"[watchdog] {self.name}: no heartbeat for {idle:.0f}s "
                      f"(last step {self._last_step}); possible hang", flush=True)
                if self.kill:
                    os.kill(os.getpid(), signal.SIGTERM)
                self._last_beat = time.monotonic()  # avoid repeat-firing every poll

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True, name=f"watchdog-{self.name}")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        return False

    @property
    def fired(self) -> bool:
        return self._fired
