"""Data-parallel counting across ranks.

Port of ``approx_counter_tpu/dist/mesh.py`` over ``torch.distributed``.
The JAX package shards the sampled windows along a device mesh, replicates
the candidates, scores each shard with its Pallas kernel under
``shard_map`` and merges the per-candidate counts with a ``psum``; its
exact stage runs under XLA's auto-SPMD, whose sort and run-length count
lower to a distributed sort.  ``make_full_step`` jits all of it as one
program per cap, and its orchestrator reruns it at a larger cap when ``n_keep``
outgrows the cap.  Here a rank is one process on one card (or on the
CPU), and each rank reads only its own windows.  The step has fixed
shapes, in three segments with a collective between each pair:

  A. ``local_segment``: ``count/exact.py:exact_count_local_rows`` on this
     rank's windows, each run start dealt to its ``owner_rank`` (a hash of
     the code) in a ``[n_ranks, B]`` bucket of (code, count) slots;
  *  one ``all_to_all_single`` of the buckets (``exchange``);
  B. ``owner_segment``: the owner sorts the ``n_ranks * B`` slots it got,
     sums the counts of equal codes and keeps its first ``cap``
     (``select_counted_rows``);
  *  one ``all_gather`` of the owners' selections (``gather``);
  C. ``merge_owned``: every rank cuts the ``n_ranks * cap`` slots to the
     same first ``cap``; then the approximate counts of that selection
     over this rank's windows, summed with an ``all_reduce``, and the
     re-rank.

A bucket that would hold more than ``B`` codes sets an overflow flag, and
``n_keep > cap`` outgrows the selection: ``next_sizes`` decides the rerun
(``B`` doubled, or ``cap`` regrown as the JAX orchestrator regrows it) from
numbers every rank holds alike, so every rank issues the same
collectives.  ``Engine`` (``pipeline.py``) captures each segment as a
CUDA graph and issues the collectives between the replays, on a process
group of their own (``pass_group``).  ``approx_counts_sharded`` is the
eager approximate count: the ``csrc/nfa_sliced.cu`` kernel on a CUDA
tensor, then an ``all_reduce``.

The collectives take the device tensors as they are.  With a card per rank
they run over NCCL on the cards; ranks sharing a card run over gloo, which
stages CUDA tensors through the host itself (``cuda_layout`` picks the
backend).
Counting is order-independent, each code is summed on exactly one owner and
every window is scored on exactly one rank, so the result does not depend
on the number of ranks.  At one rank, or with no process group, no
collective runs: the engine runs the single-device fused pass, which is
``make_full_step`` on one device.
"""

from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from approx_counter_tpu_torch.core.ordering import _SIGN, compare_count_order
from approx_counter_tpu_torch.count.exact import (
    CT,
    _round_up,
    _run_sums,
    exact_count_local_rows,
    select_counted_rows,
)
from approx_counter_tpu_torch.dist.sampling import _allgather_rows
from approx_counter_tpu_torch.kernels.bpm import MAXERR, approx_counts
from approx_counter_tpu_torch.kernels.exact_stage import slot_dimers


def process_count() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def cuda_layout(env, n_dev: int, process_id: int | None = None,
                num_processes: int | None = None) -> tuple[int, str]:
    """(card index, backend) of a rank on a host with ``n_dev`` cards.  The
    local rank and the ranks on the host are ``torchrun``'s ``LOCAL_RANK``
    and ``LOCAL_WORLD_SIZE`` in ``env``, else ``process_id`` and
    ``num_processes`` (ranks started by hand, all on this host), else rank 0
    of ``WORLD_SIZE``.  CUDA tensors go over NCCL when every rank of the
    host has a card of its own, over gloo when ranks share one (NCCL
    refuses two ranks on one device); CPU tensors always over gloo."""
    local_rank = int(env.get("LOCAL_RANK", process_id or 0))
    local_size = int(env.get("LOCAL_WORLD_SIZE", num_processes
                             or env.get("WORLD_SIZE", 1)))
    backend = "cpu:gloo,cuda:nccl" if local_size <= n_dev else "gloo"
    return local_rank % n_dev, backend


def rank_device(process_id: int | None = None) -> torch.device:
    """This rank's card, ``cuda:{local rank % device_count}`` (``cuda_layout``;
    ``process_id`` defaults to the rank in the process group).  Raises when
    the host has no CUDA device."""
    n_dev = torch.cuda.device_count()
    if not torch.cuda.is_available() or n_dev == 0:
        raise RuntimeError("no CUDA device for this rank")
    if process_id is None:
        process_id = process_index()
    return torch.device("cuda", cuda_layout(os.environ, n_dev, process_id)[0])


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device_type: str = "cuda",
               timeout: float | None = None) -> None:
    """Join the process group, from ``torchrun``'s environment by default
    or from the JAX ``initialize``'s arguments (``coordinator_address`` as
    ``tcp://host:port``; the ranks are taken to share this host).  On
    ``cuda`` the rank's card and the backend follow from ``cuda_layout``;
    on ``cpu`` the backend is gloo.  A failed init raises; nothing is
    retried."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    backend = "gloo"
    if device_type == "cuda":
        device = rank_device(process_id or 0)
        backend = cuda_layout(os.environ, torch.cuda.device_count(),
                              process_id, num_processes)[1]
        torch.cuda.set_device(device)
    elif device_type != "cpu":
        raise ValueError(f"ranks run on cuda or cpu, not {device_type}")
    dist.init_process_group(backend, **kwargs)


#: (default group, the passes' group) of this process: see ``pass_group``
_PASS_GROUP: list = [None, None]


def pass_group():
    """The process group of the counting passes' collectives: a group of
    their own beside the default one, on which the caller's thread runs
    the sampling and flag all-gathers while a pass counts on the engine's
    worker thread, so that the two threads' collectives never interleave.
    It is made once for each default group (the first sharded engine does
    it, on every rank at the same point) and kept: an NCCL group sets up
    its communicator at its first collective, which takes seconds."""
    world = dist.group.WORLD
    if _PASS_GROUP[0] is not world:
        _PASS_GROUP[:] = [world, dist.new_group()]
    return _PASS_GROUP[1]


def approx_counts_sharded(peq: torch.Tensor, windows_t: torch.Tensor,
                          window_valid: torch.Tensor, k: int,
                          maxerr: int = MAXERR) -> torch.Tensor:
    """int32 [C] counts of the candidates ``peq`` (the same on every rank)
    over every rank's windows: ``approx_counts`` on this rank's shard
    ``windows_t`` [m, W_local], then an ``all_reduce(SUM)``."""
    counts = approx_counts(peq, windows_t, window_valid, k, maxerr)
    if process_count() > 1 and counts.numel():
        dist.all_reduce(counts)
    return counts


def gather_windows(windows: np.ndarray, n_valid: int):
    """Every rank's valid window rows, rank after rank, on every rank:
    ``(uint8 [N, width], N)``.  Each rank's padded shard and its valid-row
    count (its row mask is the first ``n_valid`` rows) are all-gathered.
    The counting step does not call it: each rank counts its own rows."""
    shards = _allgather_rows(windows)
    n = _allgather_rows(np.array([n_valid], np.int64))[:, 0]
    rows = np.concatenate([s[:c] for s, c in zip(shards, n)])
    return (rows if len(rows) else windows), len(rows)


_M32 = 0xFFFFFFFF


def owner_rank(codes: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """The rank that owns each int64 code (the uint64 bits of a k-mer):
    a 32-bit multiply-xorshift mix of the code's two halves, mod
    ``n_ranks``.  Each product is a 32-bit value times a constant below
    2**31, so no int64 product overflows, and each shift reads a masked,
    non-negative value, so the negative codes of k = 32 hash as their
    uint64 bits do on every device.  ``code % n_ranks`` would deal the
    k-mers by their last bases."""
    h = ((codes & _M32) * 0x5BD1E995) & _M32
    h = ((h ^ ((codes >> 32) & _M32)) * 0x27D4EB2F) & _M32
    h ^= h >> 15
    h = (h * 0x165667B1) & _M32
    h ^= h >> 13
    return h % n_ranks


#: The statistics each owner's gathered row carries after its ``cap``
#: codes and counts: its distinct codes and survivors, then the totals of
#: every rank's N-containing k-mers and bucket overflow (equal on every
#: owner), and this rank's run starts and those it sent to other ranks.
STATS = ("n_unique", "n_pass", "had_n", "overflow", "local", "sent")
#: a bucket row's columns after its B codes and B counts (every row alike)
_SEND_STATS = ("overflow", "had_n", "local", "sent")


def bucket_slots(positions: int, n_ranks: int) -> int:
    """A bucket's first size: a rank's ``positions`` over the ranks plus
    four times their square root, rounded up to ``CT``.  An owner's share
    of a rank's distinct codes has a standard deviation of at most half
    that root, so the margin is eight of them."""
    return _round_up(-(-positions // n_ranks) + 4 * math.isqrt(positions),
                     CT) or CT


def bucket_max(positions: int) -> int:
    """The bucket size no rank can overflow: every position of a rank."""
    return max(_round_up(positions, CT), CT)


def next_sizes(overflow: bool, n_keep: int, cap: int, bucket: int,
               positions: int):
    """The ``(cap, bucket)`` to run the step again at, or None when this
    run's result stands: a bucket overflow doubles the bucket (up to
    ``bucket_max``), then an ``n_keep`` above ``cap`` regrows the cap to
    ``n_keep`` rounded up to ``CT``."""
    if overflow:
        return cap, min(2 * bucket, bucket_max(positions))
    if n_keep > cap:
        return _round_up(n_keep, CT), bucket
    return None


def agreed_positions(shape, k: int) -> int:
    """The most sliding positions, ``(m - k + 1) * n``, of any rank's
    ``[n, m]`` batch, from an all-gather of each rank's count on the
    default group: every rank sizes its buckets from it, so their
    ``all_to_all_single`` splits agree."""
    n, m = shape
    local = np.array([max(m - k + 1, 0) * n], np.int64)
    return int(_allgather_rows(local).max())


def local_segment(windows_t: torch.Tensor, row_mask: torch.Tensor, k: int,
                  n_ranks: int, bucket: int, me: int) -> torch.Tensor:
    """Segment A: this rank's windows (uint8 ``[m, n]``, bool row mask
    ``[n]``) counted (``exact_count_local_rows``) and dealt to their
    owners: int64 ``[n_ranks, 2 * bucket + 4]``, row r the first ``bucket``
    run starts owned by rank r (codes, then counts; unused slots code 0,
    count 0), then ``_SEND_STATS``: whether any owner got more than
    ``bucket``, this rank's N-containing k-mers, its run starts and those
    owned by another rank.  No host sync."""
    codes, counts, had_n = exact_count_local_rows(windows_t, row_mask, k)
    start = counts > 0
    owner = owner_rank(codes, n_ranks)
    dump = n_ranks * bucket  # one slot past the buckets takes the rest
    slot = torch.full_like(codes, dump)
    sizes = []
    for r in range(n_ranks):
        mine = start & (owner == r)
        pos = torch.cumsum(mine, 0) - 1
        slot = torch.where(mine & (pos < bucket), r * bucket + pos, slot)
        sizes.append(mine.sum())
    sizes = torch.stack(sizes)
    flat = codes.new_zeros((2, dump + 1))
    flat[0].scatter_(0, slot, codes)
    flat[1].scatter_(0, slot, counts)
    send = codes.new_empty((n_ranks, 2 * bucket + len(_SEND_STATS)))
    send[:, :2 * bucket] = flat[:, :dump].view(2, n_ranks, bucket).transpose(
        0, 1).reshape(n_ranks, 2 * bucket)
    local = sizes.sum()
    send[:, 2 * bucket:] = torch.stack([(sizes > bucket).long().max(), had_n,
                                        local, local - sizes[me]])
    return send


def owner_segment(recv: torch.Tensor, k: int, lc_sum_thr: int,
                  forbidden: torch.Tensor, limit: int, solid_km: int,
                  cap: int, me: int) -> torch.Tensor:
    """Segment B: the ``[n_ranks, 2 * bucket + 4]`` buckets this rank got
    (``local_segment``'s rows for it) -> this owner's row, int64
    ``[2 * cap + len(STATS)]``: its first ``cap`` codes in CompareCount
    order and their counts (0 past its ``n_keep``), then ``STATS``.  The
    slots are sorted, equal codes' counts summed (``_run_sums``) and
    selected by ``select_counted_rows``.  No host sync."""
    bucket = (recv.shape[1] - len(_SEND_STATS)) // 2
    s, order = torch.sort(recv[:, :bucket].reshape(-1) ^ _SIGN)
    s = s ^ _SIGN
    summed = _run_sums(s, recv[:, bucket:2 * bucket].reshape(-1)[order])
    sel = select_counted_rows(s, summed, k, lc_sum_thr, forbidden, limit,
                              solid_km, cap)
    tail = recv[:, 2 * bucket:]
    stats = torch.stack([sel["n_unique"], sel["n_pass"], tail[:, 1].sum(),
                         tail[:, 0].max(), tail[me, 2], tail[me, 3]])
    return torch.cat([sel["sel_codes"],
                      torch.where(sel["sel_valid"], sel["sel_counts"], 0),
                      stats])


def merge_owned(gathered: torch.Tensor, k: int, limit: int, solid_km: int,
                cap: int):
    """Segment C's start: every owner's row (``[n_ranks, 2 * cap +
    len(STATS)]``) -> ``(ex, stats)``: ``ex`` as ``exact_count_select_rows``
    returns it for the union of every rank's windows (the first ``cap``
    codes in CompareCount order of the owners' selections, the totals) and
    ``stats`` the ``[n_ranks, len(STATS)]`` block.  CompareCount is a
    total order on distinct codes and each code lives on one owner, so the
    global first ``cap`` are among the owners' first ``cap``.  No host
    sync."""
    codes = gathered[:, :cap].reshape(-1)
    counts = gathered[:, cap:2 * cap].reshape(-1)
    stats = gathered[:, 2 * cap:]
    top = compare_count_order(codes, counts, k, counts > 0,
                              slot_dimers(codes, k))[:cap]
    sel_codes, sel_counts = codes[top], counts[top]
    n_pass = stats[:, 1].sum()
    n_keep = n_pass if solid_km > 0 else n_pass.clamp(max=limit)
    sel_valid = ((torch.arange(cap, device=codes.device) < n_keep)
                 & (sel_counts > 0))
    ex = dict(sel_codes=sel_codes, sel_counts=sel_counts, sel_valid=sel_valid,
              n_unique=stats[:, 0].sum(), n_pass=n_pass, n_keep=n_keep,
              had_n=stats[0, 2])
    return ex, stats


def exchange(send: torch.Tensor, group=None) -> torch.Tensor:
    """Row r of ``send`` to rank r, in one ``all_to_all_single`` of equal
    splits: row r of the result came from rank r."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def gather(row: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``row``, rank after rank, as ``[n_ranks, len(row)]``.
    The list form of ``all_gather`` (views of one tensor): torch 2.13
    deprecates ``all_gather_into_tensor`` with a warning on stderr."""
    out = row.new_empty((dist.get_world_size(group), row.numel()))
    dist.all_gather(list(out.unbind(0)), row, group=group)
    return out


def traffic_report(me: int, stats: np.ndarray, sizes: list) -> dict:
    """This rank's traffic in a sharded pass's last run, from the fetched
    ``[n_ranks, len(STATS)]`` block: its run starts, those it sent to
    other ranks, the codes it owned, the bucket and cap, every ``(cap,
    bucket)`` the step ran at, and the survivors of every owner's
    filters."""
    row = dict(zip(STATS, (int(x) for x in stats[me])))
    return dict(rank=me, local=row["local"], sent=row["sent"],
                owned=row["n_unique"], cap=sizes[-1][0], bucket=sizes[-1][1],
                sizes=[list(x) for x in sizes],
                n_pass=int(stats[:, STATS.index("n_pass")].sum()))


def full_step(engine, windows: np.ndarray, n_valid: int):
    """One end across the ranks (port of ``make_full_step``):
    ``(exact_sel, approx_sel, stats)`` as ``Engine.count_one_end`` gives
    them, the same on every rank.  ``engine`` is built with
    ``sharded=True``; ``windows`` is this rank's padded shard, the only
    windows the rank uploads.  The pass is ``engine.start_pass(...)
    .finish()``: on the engine's worker it runs segments A, B and C above
    as CUDA graphs (eagerly on the CPU) with the three collectives between
    them on the passes' own process group (``pass_group``), fetches one
    packed vector, and reruns at the sizes ``next_sizes`` gives; at one
    rank it runs the single-device fused pass."""
    return engine.count_one_end(windows, n_valid)
