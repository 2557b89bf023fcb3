"""The work the count kernel's inputs need, and the least time a card
could take for it.

The count kernel (``csrc/nfa_sliced.cu``) scores C candidate k-mers
against W windows of m bases with up to e edits on the level NFA of Wu
and Manber, sliced across candidates: one 32-bit word holds one state
(pattern position, error level) of 32 candidates.  At each base of a
window every one of the (e + 1) k state words of every group of 32
candidates has to be updated, and an update takes one 32-bit integer
operation at the least, so the inputs need

    ops = ceil(C / 32) * W * m * (e + 1) * k

with C the pass's ``n_keep`` (its candidates, not the padding of its
cap), W its ``n_valid`` windows and m their bases (sl at a start, sl + 1
at an end).  The count depends on the shapes alone; it leaves out the
per-window count and the states a level reaches by deletions alone, so it
is a floor.  Bytes: each input and output once, W * m bases (1 byte
each), C codes (8 bytes) and C counts (4 bytes).

The card's peak is SMs * INT32 lanes per SM * the largest SM clock in
32-bit integer operations a second, and its HBM bandwidth, from
``peaks.json``; the least time is the larger of ops over the one and
bytes over the other.
"""

import json
import math
from pathlib import Path

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def ops(n_keep: int, n_valid: int, bases: int, maxerr: int, k: int) -> int:
    return math.ceil(n_keep / 32) * n_valid * bases * (maxerr + 1) * k


def nbytes(n_keep: int, n_valid: int, bases: int) -> int:
    return n_valid * bases + n_keep * (8 + 4)


def peak(card: dict):
    """(ops/s, bytes/s) of ``card`` (``harness.card_info``), or None for
    a card ``peaks.json`` does not hold."""
    table = json.loads(PEAKS.read_text()).get(card.get("name"))
    if table is None:
        return None
    sms = card.get("sm_count", table["sm_count"])
    mhz = card.get("max_sm_clock_mhz", table["max_sm_clock_mhz"])
    ops_s = sms * table["int32_lanes_per_sm"] * mhz * 1e6
    return ops_s, table["hbm_bytes_per_s"]


def least_s(n_keep, n_valid, bases, maxerr, k, card_peak) -> float:
    """Seconds the card needs at the least for one pass's counts."""
    ops_s, bytes_s = card_peak
    return max(ops(n_keep, n_valid, bases, maxerr, k) / ops_s,
               nbytes(n_keep, n_valid, bases) / bytes_s)
