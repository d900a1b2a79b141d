"""Terminal viewport — the DXRTViewportWidget analog for headless boxes.

Renders frames as 24-bit-color ANSI half-block characters (each text cell
shows two stacked pixels via '▀' with independent fg/bg colors) and reads
raw keystrokes (termios cbreak) for the same control surface as the
reference viewport (DXRTViewportWidget.cpp + DXRTApp WASD handling):

  w/a/s/d   move forward/left/back/right      (DXRTApp.cpp:92-107)
  arrows    look (yaw/pitch)                   (mouse-look analog, :50-72)
  q/e       zoom out/in                        (wheel analog, :74-78)
  0-6       debug shading mode                 (combo box analog)
  g         toggle Whitted shading
  p         save frame as PNG
  x / Esc   quit
"""

from __future__ import annotations

import os
import select
import sys

import numpy as np

ESC = "\x1b"


def terminal_size():
    try:
        sz = os.get_terminal_size()
        if sz.columns >= 2 and sz.lines >= 3:
            return sz.columns, sz.lines
    except OSError:
        pass
    return 80, 24


def frame_to_ansi(img_u8: np.ndarray, max_cols: int | None = None,
                  max_rows: int | None = None) -> str:
    """Encode an (H, W, 3) u8 image as ANSI half-block art."""
    cols, lines = terminal_size()
    max_cols = max_cols or cols
    max_rows = max_rows or (lines - 2)
    h, w, _ = img_u8.shape
    # Each text row shows 2 pixel rows; nearest-neighbor downsample to fit.
    target_w = min(max_cols, w)
    target_h = min(max_rows * 2, h)
    ys = (np.arange(target_h) * (h / target_h)).astype(np.int32)
    xs = (np.arange(target_w) * (w / target_w)).astype(np.int32)
    small = img_u8[ys][:, xs]
    if target_h % 2:
        small = small[:-1]
    top = small[0::2]
    bot = small[1::2]
    out = []
    for rt, rb in zip(top, bot):
        row = []
        for (r1, g1, b1), (r2, g2, b2) in zip(rt, rb):
            row.append(f"{ESC}[38;2;{r1};{g1};{b1}m{ESC}[48;2;{r2};{g2};{b2}m▀")
        out.append("".join(row) + f"{ESC}[0m")
    return "\n".join(out)


class RawKeyboard:
    """Context manager: cbreak terminal + non-blocking key/mouse polling.

    With ``mouse=True`` the terminal is switched into xterm any-motion
    tracking (DECSET 1003) with SGR extended coordinates (DECSET 1006) —
    the SSH-friendly analog of the reference viewport's FPS mouse capture
    (DXRTViewportWidget.cpp:33-72).  ``poll`` then also yields tuples:

      ("mouse_drag",  dx, dy)  — cell deltas while a button is held
      ("mouse_wheel", steps)   — +1 wheel-up / -1 wheel-down per event

    Terminals without mouse support simply never send the sequences.
    """

    def __init__(self, mouse: bool = False):
        self.mouse = mouse
        self._last_xy = None

    def __enter__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        if self.mouse:
            sys.stdout.write(f"{ESC}[?1003h{ESC}[?1006h")
            sys.stdout.flush()
        return self

    def __exit__(self, *exc):
        import termios

        if self.mouse:
            sys.stdout.write(f"{ESC}[?1006l{ESC}[?1003l")
            sys.stdout.flush()
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def _pending(self, timeout=0.0) -> bool:
        return bool(select.select([sys.stdin], [], [], timeout)[0])

    def _mouse_event(self):
        """Parse the tail of an SGR mouse report: <Cb;Cx;CyM (or m)."""
        buf = ""
        while self._pending(0.005) and len(buf) < 24:
            c = sys.stdin.read(1)
            if c in ("M", "m"):
                try:
                    b, x, y = (int(v) for v in buf.split(";"))
                except ValueError:
                    return None
                if b & 64:  # wheel: 64 = up, 65 = down
                    return ("mouse_wheel", 1 if (b & 3) == 0 else -1)
                dragging = c == "M" and (b & 32) and (b & 3) != 3
                last, self._last_xy = self._last_xy, (x, y)
                if dragging and last is not None:
                    return ("mouse_drag", x - last[0], y - last[1])
                if c == "m" or (b & 3) == 3:  # release: drop the anchor
                    self._last_xy = None
                return None
            buf += c
        return None

    def poll(self):
        """Next pending event: a key string, a mouse tuple, or None."""
        if not self._pending():
            return None
        ch = sys.stdin.read(1)
        if ch != ESC:
            return ch
        # CSI sequences: arrows ESC[A-D, SGR mouse ESC[<b;x;yM.
        if self._pending(0.005):
            seq = sys.stdin.read(1)
            if seq == "[" and self._pending(0.005):
                code = sys.stdin.read(1)
                if code == "<":
                    return self._mouse_event()
                return {"A": "up", "B": "down", "C": "right",
                        "D": "left"}.get(code, None)
        return "esc"


def home_cursor() -> str:
    return f"{ESC}[H"


def clear_screen() -> str:
    return f"{ESC}[2J{ESC}[H"
