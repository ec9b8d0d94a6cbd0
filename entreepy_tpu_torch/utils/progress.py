"""Animated terminal progress bar (host-side UX parity).

The reference renders a 30-character ANSI-truecolor animated gradient bar on
a dedicated thread polling shared progress state every 10 ms, with two color
themes — blues for encode, purple/red/orange for decode
(``progress_bar.zig:9-67``). This is the Python equivalent: a daemon thread,
the same two gradient palettes, a box-drawn frame, and a status message line.
Suppressed when output is not a TTY or when printing/debug output would
collide with it (matching ``encode.zig:35``, ``decode.zig:23``).
"""

from __future__ import annotations

import sys
import threading
import time

BAR_LENGTH = 30
STEPS_PER_COLOR = 60

THEMES = {
    0: [(0x00, 0xB4, 0xD8), (0x90, 0xE0, 0xEF), (0xCA, 0xC0, 0xF8), (0x90, 0xE0, 0xEF)],
    1: [(0x83, 0x3A, 0xB4), (0xE7, 0x22, 0x38), (0xFC, 0xB0, 0x45), (0xE7, 0x22, 0x38)],
}


class ProgressBar:
    """Background-rendered progress bar.

    >>> bar = ProgressBar(theme=0)
    >>> bar.start()
    >>> bar.update(40, "Writing compressed text...")
    >>> bar.finish("Done compressing!")
    """

    def __init__(self, theme: int = 0, stream=None, enabled: bool | None = None):
        self.stops = THEMES.get(theme, THEMES[1])
        self.stream = stream if stream is not None else sys.stderr
        isatty = getattr(self.stream, "isatty", lambda: False)()
        self.enabled = isatty if enabled is None else enabled
        self._progress = 0
        self._msg = "Working..."
        self._step = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # update() renders synchronously from the codec thread while the
        # 10 ms poll thread renders too; the lock keeps the \r-prefixed
        # frames from interleaving on the shared stream.
        self._render_lock = threading.Lock()

    def start(self):
        if not self.enabled or self._thread is not None:
            return
        self.stream.write("\n\n\n\n")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def update(self, progress: int, msg: str | None = None):
        self._progress = min(int(progress), 100)
        if msg is not None:
            self._msg = msg
        # Render a frame synchronously too: measured phase ticks faster than
        # the 10 ms poll still produce a visible frame each.
        if self._thread is not None:
            self._render(self._step)

    def finish(self, msg: str | None = None):
        self.update(100, msg)
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None

    def _color(self, step: int):
        a = self.stops[(step // STEPS_PER_COLOR) % 3]
        b = self.stops[((step // STEPS_PER_COLOR) + 1) % 3]
        t = step % STEPS_PER_COLOR
        return tuple(a[i] + (b[i] - a[i]) * t // STEPS_PER_COLOR for i in range(3))

    def _render(self, step: int):
        done = self._progress * BAR_LENGTH // 100
        cells = []
        for j in range(done):
            r, g, b = self._color(step + j)
            cells.append(f"\x1b[38;2;{r};{g};{b}m█\x1b[m")
        bar = "".join(cells) + " " * (BAR_LENGTH - done)
        top = "╔" + "═" * (BAR_LENGTH + 2) + "╗"
        bot = "╚" + "═" * (BAR_LENGTH + 2) + "╝"
        with self._render_lock:
            self.stream.write(
                f"\x1b[4F\x1b[0J{self._msg}\n{top}\n║ {bar} ║\n{bot}\n"
            )
            self.stream.flush()

    def _run(self):
        while True:
            self._render(self._step)
            if self._progress >= 100 or self._stop.is_set():
                self._render(self._step)
                return
            self._step += 1
            time.sleep(0.01)
