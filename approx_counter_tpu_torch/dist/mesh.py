"""Data-parallel counting across ranks.

Port of ``approx_counter_tpu/dist/mesh.py`` over ``torch.distributed``.
The JAX package shards the sampled windows along a device mesh, replicates
the candidates, scores each shard with its Pallas kernel under
``shard_map`` and merges the per-candidate counts with a ``psum``.  Here a
rank is one process on one card (or on the CPU):

  * ``approx_counts_sharded`` scores this rank's window shard with
    ``kernels/bpm.py:approx_counts`` (the ``csrc/nfa_sliced.cu`` kernel on
    a CUDA tensor) and sums the int32 counts of every rank with an
    ``all_reduce`` on the device tensor;
  * ``full_step`` all-gathers the ranks' window shards (host uint8) and runs
    the exact stage on the whole batch on every rank, then scores its own
    shard.  The ``--from-exact`` step is ``Engine.approx_stage`` of an
    engine that scores with ``approx_counts_sharded``.  The JAX step leaves the exact stage to XLA's auto-SPMD over the
    global array; torch has no such thing, and a replicated exact stage
    gives the same bytes, since counting does not depend on the window
    order.  It costs every rank the whole exact stage.

Counting is order-independent and every window is scored on exactly one
rank, so the result does not depend on the number of ranks.  At one rank,
or with no process group, no collective runs.  Torch shapes are dynamic, so
the JAX step's cap and its regrowth have no counterpart.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

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
    count (its row mask is the first ``n_valid`` rows) are all-gathered."""
    shards = _allgather_rows(windows)
    n = _allgather_rows(np.array([n_valid], np.int64))[:, 0]
    rows = np.concatenate([s[:c] for s, c in zip(shards, n)])
    return (rows if len(rows) else windows), len(rows)


def full_step(engine, windows: np.ndarray, n_valid: int):
    """One end across the ranks (port of ``make_full_step``):
    ``(exact_sel, approx_sel, stats)`` as ``Engine.count_one_end`` gives
    them, the same on every rank.  ``engine`` scores with
    ``approx_counts_sharded``; ``windows`` is this rank's padded shard.

    1. all-gather the ranks' shards (``gather_windows``);
    2. exact count and selection of the whole batch, on every rank;
    3. approximate counts of the selection over this rank's shard,
       all-reduced;
    4. CompareCount re-rank (``rank_with_zero_counts``)."""
    exact_batch = None
    if process_count() > 1:
        exact_batch = gather_windows(windows, n_valid)
    return engine.count_one_end(windows, n_valid, exact_batch)
