"""Timestamped progress logger.

Reproduces the reference's ``print()`` helper
(approx_counter.cpp:85-94): every progress line is prefixed
with ``[<ms since boot> ms]\\t`` plus one extra tab per nesting level.  The
reference formats the double with C++ default stream precision (6 significant
digits); we match that with ``%g``-style formatting.
"""

from __future__ import annotations

import sys
import time


class Log:
    """Boot-clock logger (ref boot_time at approx_counter.cpp:19)."""

    def __init__(self, stream=None):
        self.boot = time.monotonic()
        self.stream = stream if stream is not None else sys.stdout

    def __call__(self, text: str, tab: int = 0) -> None:
        ms = (time.monotonic() - self.boot) * 1000.0
        self.stream.write(f"[{ms:.6g} ms]\t" + "\t" * tab + str(text) + "\n")
        self.stream.flush()


def warn(text: str) -> None:
    """stderr warning with the reference's ``/!\\`` prefix (:777)."""
    sys.stderr.write(f"/!\\ WARNING: {text}\n")


def short_read_warning(read_id) -> str:
    """The per-read sampler warning text (approx_counter.cpp:449-457;
    'that' typo preserved).  ONE definition -- three samplers emit it
    (in-memory walk, streaming reservoirs, distributed bottom-k)."""
    return f"Cut size is longer that current read! (read id: {read_id})."


def error(text: str) -> None:
    sys.stderr.write(f"/!\\ ERROR: {text}\n")
