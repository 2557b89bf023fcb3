"""Data-parallel counting across ranks.

Port of ``approx_counter_tpu/dist/mesh.py`` over ``torch.distributed``.
The JAX package shards the sampled windows along a device mesh, replicates
the candidates, scores each shard with its Pallas kernel under
``shard_map`` and merges the per-candidate counts with a ``psum``; its
exact stage runs under XLA's auto-SPMD, whose sort and run-length count
lower to a distributed sort.  Here a rank is one process on one card (or on
the CPU), and each rank reads only its own windows:

  * ``exact_count_select_sharded`` counts this rank's windows
    (``count/exact.py:exact_count_local``), sends each unique code and its
    count to the code's owner rank (``owner_rank``, a hash of the code) in
    an ``all_to_all_single``, sums and filters on the owner
    (``select_counted``), and all-gathers the owners' selections, which
    every rank cuts to the same global one;
  * ``approx_counts_sharded`` scores this rank's window shard with
    ``kernels/bpm.py:approx_counts`` (the ``csrc/nfa_sliced.cu`` kernel on
    a CUDA tensor) and sums the int32 counts of every rank with an
    ``all_reduce`` on the device tensor;
  * ``full_step`` is ``Engine.count_one_end`` on an engine built with both
    (``dist/multihost.py``).  The ``--from-exact`` step is
    ``Engine.approx_stage`` of the same engine.

The collectives take the device tensors as they are.  With a card per rank
they run over NCCL on the cards; ranks sharing a card run over gloo, which
stages CUDA tensors through the host itself (``cuda_layout`` picks the
backend).
Counting is order-independent, each code is summed on exactly one owner and
every window is scored on exactly one rank, so the result does not depend
on the number of ranks.  At one rank, or with no process group, no
collective runs.  Torch shapes are dynamic, so the JAX step's cap and its
regrowth have no counterpart.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from approx_counter_tpu_torch.core.ordering import compare_count_order
from approx_counter_tpu_torch.count.exact import (
    exact_count_local,
    exact_count_select,
    select_counted,
)
from approx_counter_tpu_torch.dist.sampling import _allgather_rows
from approx_counter_tpu_torch.kernels.bpm import MAXERR, approx_counts


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


def _all_gather_rows(t: torch.Tensor, width: int, lengths: list):
    """1-D ``t`` from every rank, rank after rank: padded to ``width`` (the
    longest) for an ``all_gather``, then trimmed to each rank's
    ``lengths[r]``.  The list form of ``all_gather``: torch 2.13
    deprecates ``all_gather_into_tensor`` with a warning on stderr."""
    padded = t.new_zeros(width)
    padded[:t.numel()] = t
    parts = [torch.empty_like(padded) for _ in lengths]
    dist.all_gather(parts, padded)
    return torch.cat([p[:c] for p, c in zip(parts, lengths)])


def exact_count_select_sharded(
    windows_t: torch.Tensor,   # uint8 [m, n]: this rank's windows
    row_mask: torch.Tensor,    # bool [n]: which of them are real
    k: int,
    lc_sum_thr: int,
    forbidden: torch.Tensor,   # int64 [F] codes (F may be 0)
    limit: int,
    solid_km: int = 0,
) -> dict:
    """``exact_count_select`` of the union of every rank's windows, each
    rank reading only its own: the same dict, equal on every rank.

    1. ``exact local``: ``exact_count_local`` on this rank's windows;
    2. ``exact exchange``: each unique code goes with its count to its
       ``owner_rank``: the split sizes in one ``all_to_all_single`` (one
       host sync), then the codes and the counts, int64 each, in one each;
    3. ``exact owner``: the owner sorts what it received, sums the counts
       of equal codes and selects (``select_counted``: DUST and the
       forbidden list read the code, the solid threshold the summed
       count): its top ``limit`` in CompareCount order, or in solid mode
       every survivor;
    4. ``exact gather``: the owners' selections are all-gathered (lengths
       first, then padded to the longest), put in CompareCount order and
       cut to ``limit`` (solid mode: kept whole), and ``had_n``,
       ``n_unique`` and ``n_pass`` are summed in one ``all_reduce``.

    CompareCount is a total order on distinct codes and each code lives
    on one owner, so the global first ``limit`` are among the owners'
    first ``limit``.  Each call appends this rank's traffic (codes sent
    to other ranks, codes owned, entries gathered) to
    ``exact_count_select_sharded.traffic``.  At one rank, or with no
    process group, it is ``exact_count_select``."""
    n_ranks = process_count()
    if n_ranks == 1:
        return exact_count_select(windows_t, row_mask, k, lc_sum_thr,
                                  forbidden, limit, solid_km)
    me = process_index()
    record = torch.profiler.record_function
    with record("exact local"):
        codes, counts, had_n = exact_count_local(windows_t, row_mask, k)
        owner = owner_rank(codes, n_ranks)
        by_owner = torch.sort(owner, stable=True).indices
        codes, counts = codes[by_owner], counts[by_owner]
        send = torch.bincount(owner, minlength=n_ranks)
    with record("exact exchange"):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        send_sizes, recv_sizes = torch.stack([send, recv]).tolist()
        got_codes = codes.new_empty(sum(recv_sizes))
        got_counts = counts.new_empty(sum(recv_sizes))
        dist.all_to_all_single(got_codes, codes, recv_sizes, send_sizes)
        dist.all_to_all_single(got_counts, counts, recv_sizes, send_sizes)
    with record("exact owner"):
        got_codes, order = torch.sort(got_codes)
        owned, inverse = torch.unique_consecutive(got_codes,
                                                  return_inverse=True)
        summed = torch.zeros_like(owned).index_add_(0, inverse,
                                                    got_counts[order])
        sel = select_counted(owned, summed, k, lc_sum_thr, forbidden, limit,
                             solid_km)
    with record("exact gather"):
        lengths = send.new_tensor([sel["n_keep"]])
        parts = [torch.empty_like(lengths) for _ in range(n_ranks)]
        dist.all_gather(parts, lengths)
        lengths = torch.cat(parts).tolist()
        width = max(lengths)
        all_codes = all_counts = sel["sel_codes"]
        if width:
            all_codes = _all_gather_rows(sel["sel_codes"], width, lengths)
            all_counts = _all_gather_rows(sel["sel_counts"], width, lengths)
        totals = torch.stack([had_n, had_n.new_tensor(owned.numel()),
                              had_n.new_tensor(sel["n_pass"])])
        dist.all_reduce(totals)
        had_n, n_unique, n_pass = totals.tolist()
        n_keep = n_pass if solid_km > 0 else min(n_pass, limit)
        order = compare_count_order(all_codes, all_counts, k)[:n_keep]
    exact_count_select_sharded.traffic.append(dict(
        rank=me, local=codes.numel(),
        sent=codes.numel() - send_sizes[me], owned=owned.numel(),
        gathered=width * n_ranks))
    return dict(sel_codes=all_codes[order], sel_counts=all_counts[order],
                n_unique=n_unique, n_pass=n_pass, n_keep=n_keep,
                had_n=had_n)


exact_count_select_sharded.traffic = []


def full_step(engine, windows: np.ndarray, n_valid: int):
    """One end across the ranks (port of ``make_full_step``):
    ``(exact_sel, approx_sel, stats)`` as ``Engine.count_one_end`` gives
    them, the same on every rank.  ``engine`` counts with
    ``exact_count_select_sharded`` and scores with
    ``approx_counts_sharded``; ``windows`` is this rank's padded shard, the
    only windows the rank uploads.

    1. exact count of this rank's windows, each code summed and selected
       on its owner rank, the selections gathered and cut on every rank;
    2. approximate counts of the selection over this rank's shard,
       all-reduced;
    3. CompareCount re-rank (``rank_with_zero_counts``)."""
    return engine.count_one_end(windows, n_valid)
