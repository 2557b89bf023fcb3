"""Independent search-scheme enumerator -- pins the counting semantics.

A copy of the JAX package's ``approx_counter_tpu/searchscheme.py`` (numpy
only), with the same names, so that the port and its CUDA kernels are held
against it without JAX.  The one change: ``search_scheme_error_count``
also takes this package's int64 codes, which hold the uint64 bits of a
k = 32 code.

The single load-bearing assumption of the whole engine is that the
reference's SeqAn ``find<0, MAXERR>(delegate, index, needle,
EditDistance())`` call (approx_counter.cpp:586), whose
delegate marks ``tcount[errors][read_id] = true`` for every *reported*
occurrence (:556-565), yields per-read level sets equal to

    { e in [0, maxerr] : e >= d_min(needle, window) }

-- the premise of the kernel's Sigma max(0, (maxerr+1) - d_min) closed form
(kernels/bpm.py).  SeqAn is no dependency of this package, so this
module re-implements, from scratch and from the
published literature only, the machinery the reference relies on:

  * the *optimal search schemes* of Kianfar, Pockrandt, Reinert et al.
    ("Optimum Search Schemes for Approximate String Matching Using Search
    Schemes", 2018) for K <= 2 errors -- the exact scheme family SeqAn 2.4's
    ``find<0,2>`` instantiates -- plus a coverage-verified pigeonhole scheme
    for K = 3 (our --max-error extension; the reference is compile-time
    fixed at MAXERR=2);
  * a bidirectional edit-distance search executor over a plain text window
    (the direct-text equivalent of running the scheme over a bidirectional
    FM-index restricted to one read: every index path corresponds to an
    anchor position here, and occurrence multiplicity is irrelevant because
    the delegate only ORs bits).

Semantics implemented (documented assumptions, tested differentially in
tests/test_torch_searchscheme.py, and on the card by chip_smoke.py):

  * A search (pi, L, U) processes pattern pieces in pi order; the matched
    piece set is always contiguous, direction = toward the next piece.
  * Per consumed op the cumulative error count must stay <= U[t] of the
    piece being processed; when a piece completes, cumulative errors must
    be >= L[t] (else the branch is pruned -- the scheme's non-redundancy
    rule), and a final report requires e >= L[-1].
  * Edit ops: match (cost 0, only on equal ACGT chars -- text 'N'/pad never
    matches, mirroring Dna5 N vs an ACGT needle), substitution (cost 1),
    insertion = pattern-char gap (cost 1), deletion = text-char gap
    (cost 1).  Deletions are attributed to the piece of the next pattern
    char and are disallowed before the first / after the last pattern char
    of the search (no boundary text gaps -- the strictest convention; a
    SeqAn-side *more* liberal end-gap enumeration could only enlarge the
    reported level set, so equality under this strict convention is the
    strongest possible pin).
  * Pieces split the pattern as evenly as possible, first (k mod P) pieces
    one longer.  k < P yields empty pieces whose L/U checks collapse onto
    the preceding completion point (exercised at k=2, the reference's
    minimum, where find<0,2> splits a 2-mer into 3 pieces).

This module is a verification oracle (like oracle.py): deliberately clear,
never on the hot path.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Search:
    """One search of a scheme: piece order (1-based), cumulative bounds."""

    pi: tuple[int, ...]
    L: tuple[int, ...]
    U: tuple[int, ...]


#: Published optimal search schemes (Kianfar et al. 2018), indexed by K.
#: K=0/1/2 are the paper's optimal schemes (K=2 is the famous 3-search
#: scheme SeqAn's find<0,2> hardcodes); K=3 is a pigeonhole scheme (one
#: error-free piece, 4 searches) -- correct, not optimal, sufficient for
#: reported-set semantics.  All verified against the error-distribution
#: coverage criterion by scheme_covers / tests.
SCHEMES: dict[int, tuple[Search, ...]] = {
    0: (Search((1,), (0,), (0,)),),
    1: (
        Search((1, 2), (0, 0), (0, 1)),
        Search((2, 1), (0, 1), (0, 1)),
    ),
    2: (
        Search((1, 2, 3), (0, 0, 2), (0, 1, 2)),
        Search((3, 2, 1), (0, 0, 0), (0, 2, 2)),
        Search((2, 3, 1), (0, 1, 1), (1, 2, 2)),
    ),
    3: (
        Search((1, 2, 3, 4), (0, 0, 0, 0), (0, 3, 3, 3)),
        Search((2, 1, 3, 4), (0, 0, 0, 0), (0, 3, 3, 3)),
        Search((3, 4, 2, 1), (0, 0, 0, 0), (0, 3, 3, 3)),
        Search((4, 3, 2, 1), (0, 0, 0, 0), (0, 3, 3, 3)),
    ),
}


def connected(pi: tuple[int, ...]) -> bool:
    """Every prefix of pi must be a contiguous piece range (bidirectional
    searches extend the matched region on one side at a time)."""
    lo = hi = pi[0]
    for p in pi[1:]:
        if p == lo - 1:
            lo = p
        elif p == hi + 1:
            hi = p
        else:
            return False
    return True


def scheme_covers(searches: tuple[Search, ...], K: int) -> bool:
    """Coverage criterion: every error distribution (a_1..a_P) with
    sum <= K must be admitted by at least one search (cumulative piece
    error counts within [L, U] at every completion point)."""
    P = len(searches[0].pi)

    def admits(s: Search, dist: tuple[int, ...]) -> bool:
        cum = 0
        for t, piece in enumerate(s.pi):
            cum += dist[piece - 1]
            if not (s.L[t] <= cum <= s.U[t]):
                return False
        return True

    def all_dists(P: int, K: int):
        if P == 1:
            for a in range(K + 1):
                yield (a,)
            return
        for a in range(K + 1):
            for rest in all_dists(P - 1, K - a):
                yield (a,) + rest

    return all(
        any(admits(s, d) for s in searches) for d in all_dists(P, K)
    )


def split_pieces(k: int, P: int) -> list[tuple[int, int]]:
    """Pattern piece boundaries [(start, end)); first k%P pieces longer."""
    base, rem = divmod(k, P)
    out = []
    pos = 0
    for i in range(P):
        ln = base + (1 if i < rem else 0)
        out.append((pos, pos + ln))
        pos += ln
    return out


def _schedule(search: Search, pieces: list[tuple[int, int]]):
    """Expand a search into the per-pattern-char consumption schedule.

    Returns a list of (pattern_index, piece_ordinal t, direction) in
    consumption order, plus for each schedule position the set of piece
    ordinals whose completion check fires after consuming that char
    (empty pieces collapse onto the previous completion point).
    """
    sched: list[tuple[int, int, int]] = []
    completes: list[list[int]] = []
    lo = hi = None  # matched pattern piece range (1-based, inclusive)
    for t, piece in enumerate(search.pi):
        b, e = pieces[piece - 1]
        if lo is None:
            nxt = search.pi[t + 1] if len(search.pi) > t + 1 else piece + 1
            direction = 1 if nxt > piece else -1
            lo = hi = piece
        elif piece == hi + 1:
            direction = 1
            hi = piece
        elif piece == lo - 1:
            direction = -1
            lo = piece
        else:  # unreachable for connected pi
            raise ValueError(f"disconnected search order {search.pi}")
        idxs = range(b, e) if direction == 1 else range(e - 1, b - 1, -1)
        added = False
        for pidx in idxs:
            sched.append((pidx, t, direction))
            completes.append([])
            added = True
        if added:
            completes[-1].append(t)
        elif completes:
            completes[-1].append(t)  # empty piece: collapse onto previous
        else:
            # empty piece first in pi (k < P with leading empty): its check
            # fires before any char; handled by caller via pre-checks
            pass
    return sched, completes


def search_levels(
    pattern: np.ndarray, text: np.ndarray, search: Search,
    pieces: list[tuple[int, int]], maxerr: int,
) -> set[int]:
    """Error levels e with >= 1 reported occurrence of ``pattern`` in
    ``text`` under one search of a scheme (edit distance, see module doc)."""
    k = len(pattern)
    n = len(text)
    sched, completes = _schedule(search, pieces)
    assert len(sched) == k

    levels: set[int] = set()
    seen: set[tuple[int, int, int, int]] = set()

    def ok_after_char(pos: int, e: int) -> bool:
        """Completion checks firing after schedule position pos."""
        for t in completes[pos]:
            if not (search.L[t] <= e <= search.U[t]):
                return False
        return True

    def go(pos: int, t_l: int, t_r: int, e: int) -> None:
        """pos = next schedule index to consume; [t_l, t_r) text matched."""
        if pos == k:
            levels.add(e)
            return
        key = (pos, t_l, t_r, e)
        if key in seen:
            return
        seen.add(key)
        pidx, t, direction = sched[pos]
        U = search.U[t]
        pc = pattern[pidx]
        # deletion (text-char gap): attributed to piece t; disallowed before
        # the first / after the last pattern char of the search (pos==k is
        # already handled above; pos==0 is the anchor -- covered by other
        # anchors, and a boundary gap under the strict convention).
        if pos > 0 and e + 1 <= U:
            if direction == 1 and t_r < n:
                go(pos, t_l, t_r + 1, e + 1)
            elif direction == -1 and t_l > 0:
                go(pos, t_l - 1, t_r, e + 1)
        # insertion (pattern-char gap)
        if e + 1 <= U and ok_after_char(pos, e + 1):
            go(pos + 1, t_l, t_r, e + 1)
        # match / substitution
        if direction == 1 and t_r < n:
            cost = 0 if (text[t_r] == pc and text[t_r] < 4) else 1
            if e + cost <= U and ok_after_char(pos, e + cost):
                go(pos + 1, t_l, t_r + 1, e + cost)
        elif direction == -1 and t_l > 0:
            cost = 0 if (text[t_l - 1] == pc and text[t_l - 1] < 4) else 1
            if e + cost <= U and ok_after_char(pos, e + cost):
                go(pos + 1, t_l - 1, t_r, e + cost)

    if k == 0:
        return {0} if search.L[-1] == 0 else set()
    for anchor in range(n + 1):
        go(0, anchor, anchor, 0)
    return levels


@functools.lru_cache(maxsize=None)
def _scheme_for(maxerr: int) -> tuple[Search, ...]:
    scheme = SCHEMES[maxerr]
    assert all(connected(s.pi) for s in scheme)
    assert scheme_covers(scheme, maxerr), maxerr
    return scheme


def search_scheme_levels(
    pattern: np.ndarray, text: np.ndarray, maxerr: int = 2
) -> set[int]:
    """Union over the scheme's searches: the set of error levels at which
    at least one occurrence is *reported* -- exactly what the reference
    delegate's ``tcount[errors][read_id] = true`` records per read
    (approx_counter.cpp:556-586)."""
    pieces = split_pieces(len(pattern), maxerr + 1)
    out: set[int] = set()
    for s in _scheme_for(maxerr):
        out |= search_levels(pattern, text, s, pieces, maxerr)
    return out


def search_scheme_error_count(
    windows: list[np.ndarray], candidates, k: int, maxerr: int = 2,
) -> dict[int, int]:
    """errorCount via search-scheme enumeration: per candidate,
    total = Sigma_e popcount(tcount[e]) (approx_counter.cpp:590-593).

    ``candidates`` are integer codes: Python ints, numpy uint64 or int64, or
    an int64 tensor.  A negative int64 code is the uint64 code with bit 63
    set (k = 32); the result is keyed by ``int(code)`` as given."""
    out: dict[int, int] = {}
    for code in candidates:
        code = int(code)
        pat = np.empty(k, dtype=np.uint8)
        v = code & 0xFFFFFFFFFFFFFFFF
        for i in range(k - 1, -1, -1):
            pat[i] = v & 3
            v >>= 2
        total = 0
        for w in windows:
            total += len(search_scheme_levels(pat, w, maxerr))
        out[code] = total
    return out
