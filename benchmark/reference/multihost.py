"""Plain reference of the ``--multihost`` sample, in NumPy.

Written from what the program documents of its multihost run
(``dist/sampling.py``'s docstrings, COMPAT.md M1-M5), sharing no code with
it.  The reference adaptFinder has no multi-file or multi-process mode;
the program's own rules are the ones judged:

- M1: the comma-separated input files are dealt round-robin, file i to
  rank ``i % ranks``; each rank reads its files in that order.
- M2: each rank draws from ``numpy.random.default_rng(seed + 1000003 *
  rank)``, one generator for the whole job, so a run's draws continue the
  last run's.  In a run every eligible read (at least ``2 * sl`` bases) of
  the rank, in file order, draws two full-range uint64 priorities, first
  the start's, then the end's.  Each rank keeps, for each end, its
  ``sn`` smallest priorities (ties, which need two equal 64-bit draws,
  by read order) in ascending order.
- The global cut: with one rank it keeps all of them.  With more, the
  ranks exchange their kept priorities as their low 32 bits, each list
  padded to ``sn`` entries with 0xFFFFFFFF, and the cut counts, for each
  rank, how many of the ``sn`` smallest of all those entries are its own
  (equal values by rank, then by position in the list; a pad counts like
  a value).  Each rank then keeps that many of its items, the first in
  its 64-bit order.
- Windows: ``seq[:sl]`` at the start, ``seq[len - 1 - sl:]`` (sl + 1
  bases) at the end.  A pass counts the union of the ranks' windows.
- After a run, ``sn`` is cut to the reads of every rank when it is larger
  (the reference's clamp, approx_counter.cpp:844-848).
"""

from __future__ import annotations

import numpy as np

#: the stride between the ranks' seeds (M2)
RANK_STRIDE = 1000003
#: a padded entry of the exchanged priority lists (their low 32 bits)
PAD32 = np.uint32(0xFFFFFFFF)


def rank_seed(seed: int, rank: int) -> int:
    return seed + RANK_STRIDE * rank


def deal(n_files: int, ranks: int) -> list[list[int]]:
    """The files of each rank, by index (M1)."""
    return [list(range(r, n_files, ranks)) for r in range(ranks)]


def cut_counts(lists: list, sn: int) -> np.ndarray:
    """How many items each rank keeps: of each rank's priorities (uint64,
    ascending) the low 32 bits, padded to ``sn`` with ``PAD32``; the
    ``sn`` smallest entries of all ranks, equal ones by (rank,
    position)."""
    if len(lists) == 1:
        return np.array([min(len(lists[0]), sn)])
    rows = np.full((len(lists), sn), PAD32, np.uint32)
    for r, prio in enumerate(lists):
        rows[r, :len(prio)] = (prio[:sn] & np.uint64(0xFFFFFFFF)).astype(
            np.uint32)
    flat = rows.reshape(-1)
    first = np.argsort(flat, kind="stable")[:sn]
    return np.bincount(first // sn, minlength=len(lists))


class Sampler:
    """The multihost sample of one job, run by run.

    ``files``: ``(buf, offsets)`` of each input file in input order (read i
    of a file is ``buf[offsets[i]:offsets[i + 1]]``, base ordinals)."""

    def __init__(self, files: list, ranks: int, sn: int, sl: int,
                 seed: int):
        self.sn, self.sl = sn, sl
        self.shards = []
        for idx in deal(len(files), ranks):
            bufs = [files[i][0] for i in idx]
            base = np.cumsum([0] + [len(b) for b in bufs])
            starts = [files[i][1][:-1] + b for i, b in zip(idx, base)]
            lengths = [np.diff(files[i][1]) for i in idx]
            self.shards.append((np.concatenate(bufs + [np.zeros(0, np.uint8)]),
                                np.concatenate(starts + [np.zeros(0, int)]),
                                np.concatenate(lengths + [np.zeros(0, int)])))
        self.n_reads = sum(len(s[2]) for s in self.shards)
        self.rngs = [np.random.default_rng(rank_seed(seed, r))
                     for r in range(ranks)]
        self.drawn = []   # each drawn run's draws

    def _draw(self) -> list:
        """One run's draws: each rank's eligible reads and their start
        and end priorities."""
        out = []
        for (_, _, lengths), rng in zip(self.shards, self.rngs):
            elig = np.flatnonzero(lengths >= 2 * self.sl)
            draws = rng.integers(0, 1 << 64, 2 * len(elig), dtype=np.uint64)
            out.append((elig, draws[0::2], draws[1::2]))
        return out

    def rank_windows(self, run: int, end: bool) -> list:
        """Each rank's windows of ``run``'s start or end (``[n_r, sl]`` or
        ``[n_r, sl + 1]`` uint8), in that rank's priority order."""
        while len(self.drawn) <= run:
            self.drawn.append(self._draw())
        # the clamp takes effect after the first run's sample
        sn = self.sn if run == 0 else min(self.sn, self.n_reads)
        kept = []
        for elig, p_start, p_end in self.drawn[run]:
            prio = p_end if end else p_start
            order = np.lexsort((np.arange(len(prio)), prio))[:sn]
            kept.append((elig[order], prio[order]))
        counts = cut_counts([p for _, p in kept], sn)
        width = self.sl + 1 if end else self.sl
        out = []
        for (buf, starts, lengths), (ids, _), c in zip(self.shards, kept,
                                                       counts):
            ids = ids[:c]
            first = (starts[ids] + lengths[ids] - 1 - self.sl if end
                     else starts[ids])
            out.append(buf[first[:, None] + np.arange(width)])
        return out

    def windows(self, run: int, end: bool) -> np.ndarray:
        """The union of the ranks' windows of ``run``'s start or end."""
        return np.concatenate(self.rank_windows(run, end))
