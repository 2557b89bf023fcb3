"""Distributed uniform window sampling (bottom-k / priority sampling).

Port of ``approx_counter_tpu/dist/sampling.py``.  The reference samples a
uniform ``sn``-subset of the *eligible* reads (len >= 2*sl) by
shuffle-then-walk (approx_counter.cpp:415-476).  Across ranks, with each
rank streaming its own shard files, the same distribution comes from
bottom-k sampling:

  * every rank tags each eligible read of its shard with an independent
    uniform 64-bit priority (its own seeded generator) and keeps its local
    bottom-``sn``;
  * the ranks all-gather only their sorted priority lists (``sn`` uint64
    each, padded) and their read counts;
  * every rank computes the same global cutoff, the min(sn, N_eligible)-th
    smallest priority of the union, ties broken by (rank, local order), and
    keeps its items under it.  The global bottom-k of i.i.d. uniform keys
    over disjoint shards is a uniform k-subset of the union, whatever the
    shard sizes.

Start and end samples are two independent draws in the reference, so two
bottom-k structures are kept, fed by one walk.

The draws are the JAX package's, draw for draw: each eligible read draws
one ``rng.integers(0, 1 << 64, dtype=np.uint64)`` for the start structure,
then one for the end structure (also when ``sn <= 0``).  The port takes a
parsed chunk at a time and draws its ``2n`` priorities in one call, which
numpy serves as the ``2n`` scalar calls (tested).  The kept set is the JAX
heap's: the ``sn`` smallest priorities, where a later read replaces the
greatest kept one only on a strictly smaller priority.  Windows are cut and
copied as they are kept, so memory is O(sn * sl) plus one IO chunk.

The collectives are ``torch.distributed.all_gather`` of CPU tensors; at one
rank there are none, as the JAX package skips them at one process.
"""

from __future__ import annotations

import heapq

import numpy as np

from approx_counter_tpu_torch.core.codec import BASE_PAD
from approx_counter_tpu_torch.io.stream import _cut, iter_read_batches
from approx_counter_tpu_torch.sample.sampler import WindowBatch, _round_up

_PRIO_PAD = np.uint64(0xFFFFFFFFFFFFFFFF)  # sorts after every real priority


class _BottomK:
    """Streaming bottom-``sn`` window sample keyed by uniform priorities,
    fed a batch of reads at a time."""

    def __init__(self, sn: int, sl: int, end: bool):
        self.sn = sn
        self.sl = sl
        self.end = end
        self.ncols = sl + 1 if end else sl
        self.prio = np.empty(0, np.uint64)   # kept items, in no order
        self.idx = np.empty(0, np.int64)     # their arrival ordinals
        self.windows = np.empty((0, self.ncols), np.uint8)
        self.n_offered = 0

    def offer(self, reads, elig: np.ndarray, prio: np.ndarray) -> None:
        """Offer the eligible reads ``elig`` of the batch ``reads``, in
        stream order, with their priorities."""
        n_old = len(self.prio)
        idx = np.arange(self.n_offered, self.n_offered + len(elig))
        self.n_offered += len(elig)
        if self.sn <= 0:
            return
        prio_all = np.concatenate([self.prio, prio])
        idx_all = np.concatenate([self.idx, idx])
        if len(prio_all) <= self.sn:
            keep = np.arange(len(prio_all))
        elif len(np.unique(prio_all)) == len(prio_all):
            # distinct priorities: the heap keeps the sn smallest
            keep = np.sort(np.argpartition(prio_all, self.sn - 1)[:self.sn])
        else:
            keep = np.nonzero(np.isin(
                idx_all, self._heap_kept(prio_all, idx_all, n_old)))[0]
        old, new = keep[keep < n_old], keep[keep >= n_old] - n_old
        self.windows = np.concatenate(
            [self.windows[old], _cut(reads, elig[new], self.sl, self.end)])
        self.prio = prio_all[keep]
        self.idx = idx_all[keep]

    def _heap_kept(self, prio_all, idx_all, n_old: int) -> list[int]:
        """Arrival ordinals the JAX package's heap keeps when priorities
        repeat: a new read replaces the greatest kept priority (the
        earliest read among equal ones) only when its own is smaller."""
        heap = [(-p, i) for p, i in zip(prio_all[:n_old].tolist(),
                                        idx_all[:n_old].tolist())]
        heapq.heapify(heap)
        for p, i in zip(prio_all[n_old:].tolist(), idx_all[n_old:].tolist()):
            if len(heap) < self.sn:
                heapq.heappush(heap, (-p, i))
            elif -p > heap[0][0]:
                heapq.heapreplace(heap, (-p, i))
        return [i for _, i in heap]

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (priorities u64, windows), sorted by priority, then arrival."""
        order = np.lexsort((self.idx, self.prio))
        return self.prio[order], self.windows[order]


def _allgather_rows(local: np.ndarray) -> np.ndarray:
    """All-gather a same-shape array from every rank -> [world, *shape] on
    every rank (CPU tensors; uint32 and uint64 travel as the bits of their
    signed types).  Every rank must call it, in the same order, with the
    same shape."""
    import torch
    import torch.distributed as dist

    arr = np.ascontiguousarray(local)
    wide_unsigned = arr.dtype.kind == "u" and arr.itemsize > 1
    t = torch.from_numpy(arr.view(f"i{arr.itemsize}") if wide_unsigned
                         else arr)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.numpy() for o in out]).view(arr.dtype)


def global_bottomk_mask(
    prio_local: np.ndarray,  # u64 [k_local], sorted ascending
    sn: int,
    process_count: int,
    process_index: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Which local items fall in the global bottom-``sn``.

    Returns (keep_mask bool [k_local], k_per_rank int64 [pc]).  Every rank
    computes the same answer from one all-gathered [pc, sn] priority matrix
    (padded with u64 max); ties at the cutoff go by (rank, local order).

    The matrix is gathered as the JAX package gathers it across processes:
    ``process_allgather`` with JAX's 64-bit types off delivers each
    priority as its low 32 bits (uint32).  So the cut compares the low 32
    bits, a pad arrives as 0xFFFFFFFF and counts as a real entry (the
    global sample size reported is then ``sn`` even when fewer reads are
    eligible), and each rank keeps its first ``k_per_rank`` items in its
    64-bit order.  The port keeps that arithmetic for byte parity.
    """
    if process_count == 1:
        keep = np.ones(len(prio_local), bool)  # local bottom-k IS global
        return keep, np.array([len(prio_local)], dtype=np.int64)

    padded = np.full(sn, _PRIO_PAD, np.uint64)
    padded[: len(prio_local)] = prio_local
    gp = _allgather_rows(padded.astype(np.uint32))  # [pc, sn], low 32 bits
    k_per_rank = select_from_gathered(gp, sn)

    mine = np.zeros(len(prio_local), bool)
    mine[: int(k_per_rank[process_index])] = True  # sorted ascending
    return mine, k_per_rank


def select_from_gathered(gp: np.ndarray, sn: int) -> np.ndarray:
    """The global cut: gathered priority matrix [pc, sn] (rows sorted
    ascending, padded with u64 max) -> per-rank kept counts summing to
    min(sn, #real entries), the same on every rank."""
    flat = gp.reshape(-1)
    real = flat[flat != _PRIO_PAD]
    total = len(real)
    if total <= sn:
        return (gp != _PRIO_PAD).sum(axis=1).astype(np.int64)

    cutoff = np.partition(real, sn - 1)[sn - 1]
    below = gp < cutoff            # strictly in
    at = gp == cutoff              # tie candidates
    n_below = int(below.sum())
    slots = sn - n_below           # >= 1 by choice of cutoff
    # tie slots in (rank, local order) order; rows are sorted, so a rank's
    # ties are a contiguous run and lower ranks win first
    at_counts = at.sum(axis=1).astype(np.int64)
    tie_taken = np.minimum(np.maximum(slots - np.concatenate(
        [[0], np.cumsum(at_counts)[:-1]]), 0), at_counts)
    return below.sum(axis=1).astype(np.int64) + tie_taken


def distributed_sample_windows(
    paths: list[str],
    sn: int,
    sl: int,
    rng: np.random.Generator,
    process_count: int,
    process_index: int,
    row_mult: int = 8,
    chunk_size: int = 1 << 22,
    end_is_start: bool = False,
    v: int = 0,
):
    """One streaming pass over this rank's shard files -> globally uniform
    start/end samples.  ``end_is_start``: the second sample draws START
    windows again (the ``--compat-quirks`` skip_end bug,
    approx_counter.cpp:943-953).  ``v >= 2``: the per-read short-read
    stderr warning (approx_counter.cpp:449-457), read id = this rank's
    shard-stream ordinal (COMPAT M3).

    Returns (start WindowBatch, end WindowBatch, n_reads_global,
    (g_start, g_end)): both batches padded to the same ``w_local`` rows on
    every rank, ``n_valid`` this rank's share of the global sample, and
    ``g_start``/``g_end`` the global sample sizes min(sn, N_eligible) that
    the "Sampled N sequences" log line reports.
    """
    bk_start = _BottomK(sn, sl, end=False)
    bk_end = _BottomK(sn, sl, end=not end_is_start)
    n_reads = 0
    for reads in iter_read_batches(paths, chunk_size):
        lengths = reads.lengths
        if v >= 2:
            from approx_counter_tpu_torch.io.logging import (
                short_read_warning,
                warn,
            )

            for i in np.nonzero(lengths < sl)[0]:
                warn(short_read_warning(n_reads + int(i)))
        n_reads += len(reads)
        elig = np.nonzero(lengths >= 2 * sl)[0]  # approx_counter.cpp:461
        if not len(elig):
            continue
        # one draw per eligible read and structure: start, end, start, ...
        draws = rng.integers(0, 1 << 64, size=2 * len(elig), dtype=np.uint64)
        bk_start.offer(reads, elig, draws[0::2])
        bk_end.offer(reads, elig, draws[1::2])

    width = sl + 1  # unified batch width (sample/sampler.py module doc)
    batches = []
    k_vectors = []
    for bk in (bk_start, bk_end):
        prio, wins = bk.items()
        keep, k_per_rank = global_bottomk_mask(
            prio, sn, process_count, process_index
        )
        k_vectors.append(k_per_rank)
        batches.append((wins[keep], bk.ncols))

    # equal local row counts on every rank
    max_k = max(int(kv.max()) for kv in k_vectors)
    w_local = max(_round_up(max_k, row_mult), row_mult)

    out = []
    for kept, ncols in batches:
        wb = np.full((w_local, width), BASE_PAD, np.uint8)
        wb[: len(kept), :ncols] = kept
        out.append(WindowBatch(windows=wb, n_valid=len(kept)))

    if process_count > 1:
        n_reads = int(_allgather_rows(np.array([n_reads], np.int64)).sum())
    g_counts = tuple(int(kv.sum()) for kv in k_vectors)
    return out[0], out[1], n_reads, g_counts
