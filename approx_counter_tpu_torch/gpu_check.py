"""On-card differential check of the port: every kernel family against the
plain Myers scan, and the exact stage and the whole pass against the oracle.

    python -m approx_counter_tpu_torch.gpu_check

Port of the JAX package's ``native/tpu_check.py`` for the parts whose
modules the port has.  The CPU tests reach only the plain versions; this
check runs the CUDA kernels themselves, on the card, in one process.
Checks:

  * kernel families: the sliced level NFA (``approx_counts``), unpacked
    Myers, packed Myers at pack 2 and 4 and the packed level NFA at pack 1,
    2, 4, 8 and 16 (wherever k <= 32 / pack), each against
    ``approx_counts_ref`` over k in {2, 8, 16, 31, 32} x maxerr 0-3, on
    C=64 candidates and W=512 windows of m=40 symbols 0-5 (N and pad
    included) with 17 invalid tail windows;
  * the exact stage (k=8, 256 windows, limit 32) against
    ``oracle_count_kmers`` / ``oracle_get_most_frequent``;
  * ``Engine.count_one_end`` at k=8 and k=17 against the oracle pipeline:
    the exact selection, the re-ranked approximate counts and ``had_n``,
    in top-N mode and in solid mode (``-sk 2``: ``oracle_get_solid_kmers``,
    more candidates than ``limit``, the approximate ranking cut to it);
  * ``Engine.approx_stage``, the resume pass, on an explicit code list
    with a repeated code and more codes than ``limit``, against
    ``oracle_error_count``;
  * the multihost step, ``dist/mesh.py:full_step`` at world size 1 (k=8,
    121 valid windows of 512, limit 37), against the oracle pipeline;
  * the window upload: the three torch unpackers on the device against the
    batch they packed (256 windows of 101, 250 valid with 100 real symbols
    and 59 Ns), then ``Engine.device_windows`` (native sparse-N pack,
    pinned staging, non-blocking copy, unpack) on that batch and on one
    with more than 4,096 Ns, which goes dense;
  * the device window pool: ``Engine.build_pool`` and a pool pass
    (``start_pass_pool``) at each end (k=8, 41 of 60 reads, limit 37)
    against the oracle pipeline.

``kernel_runs`` (every kernel configuration for a k) and
``searchscheme_case`` (adversarial windows for the search-scheme oracle)
also serve ``chip_smoke.py``'s search-scheme phase and the tests.

Every count is an integer and every comparison exact.  Prints one row per
check, then ``GPU-CHECK PASS`` or ``GPU-CHECK FAIL (n)``; exits 1 on any
failure or when no CUDA device is present.  Writes no file.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from approx_counter_tpu_torch.core.codec import (
    BASE_N,
    BASE_PAD,
    NCAP,
    pack_windows_host,
    pack_windows_sparse,
    unpack_windows,
    unpack_windows_sparse,
    unpack_windows_sparse_t,
)
from approx_counter_tpu_torch.core.complexity import (
    adjust_threshold,
    lc_sum_threshold,
)
from approx_counter_tpu_torch.count.exact import exact_count_select
from approx_counter_tpu_torch.dist.mesh import full_step
from approx_counter_tpu_torch.io.fastx import Reads
from approx_counter_tpu_torch.kernels.bpm import (
    approx_counts,
    approx_counts_myers,
    approx_counts_packed,
    approx_counts_packed_ref,
    approx_counts_ref,
    build_peq,
)
from approx_counter_tpu_torch.oracle import (
    oracle_count_kmers,
    oracle_error_count,
    oracle_get_most_frequent,
    oracle_get_solid_kmers,
    oracle_sort_compare_count,
)
from approx_counter_tpu_torch.params import Params
from approx_counter_tpu_torch.pipeline import Engine

KS = (2, 8, 16, 31, 32)


def kernel_runs(k: int) -> list[tuple[str, object, object]]:
    """(name, wrapper, plain version) of every approximate-count kernel
    configuration that takes k: the sliced level NFA, unpacked Myers, packed
    Myers at pack 2 and 4 and the packed NFA at pack 1, 2, 4, 8 and 16,
    wherever k <= 32 / pack (named ``sliced``, ``myers``, ``myers-p<pack>``
    and ``nfa-p<pack>``).  Each callable takes ``(peq, windows_t,
    window_valid, k, maxerr)``."""
    runs = [("sliced", approx_counts, approx_counts_ref),
            ("myers", approx_counts_myers, approx_counts_ref)]
    for algo, packs in (("myers", (2, 4)), ("nfa", (1, 2, 4, 8, 16))):
        runs += [(f"{algo}-p{p}",
                  functools.partial(approx_counts_packed, pack=p, algo=algo),
                  functools.partial(approx_counts_packed_ref, pack=p,
                                    algo=algo))
                 for p in packs if k <= 32 // p]
    return runs


def searchscheme_case(rng, C: int, W: int, m: int, k: int,
                      n_invalid: int = 3):
    """Adversarial inputs for holding the kernels to the search-scheme
    oracle: C seeded candidates and W windows of m symbols 0-5 (N and pad
    included), window w built around candidate ``(w + w // 8) % C`` by its
    kind ``w % 8``:

      0, 1  an exact occurrence at the first / at the last position;
      2     a substitution in an occurrence at the first position;
      3     a deletion in an occurrence ending at the last position;
      4     a valid prefix shorter than k (the candidate's), then pad;
      5     all N;
      6     symbols drawn uniformly from 0-5;
      7     an insertion in an occurrence inside the window.

    Outside what its kind sets, a window holds bases with 2% N.  The last
    ``n_invalid`` windows are invalid.  Needs m >= k + 2.  Returns numpy (codes int64 [C] holding the
    uint64 bits, windows_t uint8 [m, W], valid bool [W])."""
    pats = rng.integers(0, 4, (C, k)).astype(np.uint8)
    codes = np.zeros(C, np.uint64)
    for i in range(k):
        codes = (codes << np.uint64(2)) | pats[:, i].astype(np.uint64)
    wins = rng.integers(0, 4, (W, m)).astype(np.uint8)
    wins[rng.random((W, m)) < 0.02] = BASE_N
    for w in range(W):
        pat = pats[(w + w // 8) % C].copy()
        kind = w % 8
        if kind in (0, 2):
            if kind == 2:
                i = rng.integers(0, k)
                pat[i] = (pat[i] + rng.integers(1, 4)) % 4
            wins[w, :k] = pat
        elif kind == 1:
            wins[w, m - k:] = pat
        elif kind == 3:
            wins[w, m - k + 1:] = np.delete(pat, rng.integers(0, k))
        elif kind == 4:
            n = rng.integers(0, k)
            wins[w, :n] = pat[:n]
            wins[w, n:] = BASE_PAD
        elif kind == 5:
            wins[w] = BASE_N
        elif kind == 6:
            wins[w] = rng.integers(0, 6, m)
        else:
            ins = np.insert(pat, rng.integers(1, k), rng.integers(0, 4))
            p = rng.integers(1, m - k)
            wins[w, p:p + k + 1] = ins
    valid = np.ones(W, bool)
    valid[W - n_invalid:] = False
    return codes.view(np.int64), np.ascontiguousarray(wins.T), valid


def _kernel_rows(rng, device) -> list[tuple[str, bool]]:
    C, W, m = 64, 512, 40
    rows = []
    for k in KS:
        for maxerr in range(4):
            codes = rng.integers(0, 1 << min(2 * k, 63), C, dtype=np.uint64)
            peq = build_peq(torch.from_numpy(codes.view(np.int64)).to(device), k)
            wins = torch.from_numpy(
                rng.integers(0, 6, (m, W)).astype(np.uint8)).to(device)
            valid = torch.ones(W, dtype=torch.bool, device=device)
            valid[-17:] = False
            args = (peq, wins, valid, k, maxerr)
            want = approx_counts_ref(*args)
            for name, fn, _ in kernel_runs(k):
                rows.append((f"k={k:2d} maxerr={maxerr} {name:9s}",
                             torch.equal(fn(*args), want)))
    return rows


def _exact_stage_row(rng, device) -> tuple[str, bool]:
    k, n, m, limit = 8, 256, 45, 32
    wins = rng.integers(0, 4, (n, m)).astype(np.uint8)
    wins[1] = wins[0]  # counts > 1 above the count-1 tie class
    out = exact_count_select(
        torch.from_numpy(np.ascontiguousarray(wins.T)).to(device),
        torch.ones(n, dtype=torch.bool, device=device), k,
        lc_sum_threshold(100.0, k),
        torch.zeros(0, dtype=torch.int64, device=device), limit,
    )
    got = list(zip(out["sel_codes"].cpu().numpy().view(np.uint64).tolist(),
                   out["sel_counts"].cpu().tolist()))
    counter, _ = oracle_count_kmers(list(wins), k, 100.0, set())
    return ("exact stage k= 8 vs oracle",
            got == oracle_get_most_frequent(counter, limit, k))


def _pass_windows(rng, k, sl, n, n_valid):
    """[n, sl+1] windows with count-2 and count-3 rows and Ns, and the
    oracle's view of their valid rows."""
    wins = np.full((n, sl + 1), BASE_PAD, np.uint8)
    wins[:n_valid, :sl] = rng.integers(0, 4, (n_valid, sl))
    wins[2] = wins[1]  # count-2 class
    wins[3] = wins[1]  # count-3 class member
    wins[5] = wins[4]
    for _ in range(23):  # Ns inside the valid region
        wins[rng.integers(0, n_valid), rng.integers(0, sl)] = BASE_N
    return wins, [wins[i, :sl] for i in range(n_valid)]


def _pairs(codes, counts) -> list[tuple[int, int]]:
    return list(zip(codes.tolist(), counts.tolist()))


def _pass_rows(rng, device) -> list[tuple[str, bool]]:
    rows = []
    for k, sl, n, n_valid, limit, solid_km in (
            (8, 24, 128, 121, 37, 0), (17, 20, 64, 59, 21, 0),
            (8, 24, 64, 61, 12, 2), (17, 30, 64, 59, 9, 2)):
        wins, texts = _pass_windows(rng, k, sl, n, n_valid)
        counter, had_n = oracle_count_kmers(
            texts, k, adjust_threshold(1.0, 16, k), set())
        if solid_km:
            sel = oracle_get_solid_kmers(counter, solid_km, k)
        else:
            sel = oracle_get_most_frequent(counter, limit, k)
        ranked = oracle_sort_compare_count(
            oracle_error_count(texts, [c for c, _ in sel], k), k)[:limit]

        engine = Engine(Params(k=k, sl=sl, limit=limit, solid_km=solid_km,
                               param_lc=1.0), device)
        (ec, ecnt), (ac, acnt), stats = engine.count_one_end(wins, n_valid)
        ok = (_pairs(ec, ecnt) == sel and _pairs(ac, acnt) == ranked
              and stats["had_n"] == had_n
              and (not solid_km or len(sel) > limit))
        mode = f"-sk {solid_km}" if solid_km else "top-N"
        rows.append((f"whole pass k={k:2d} {mode} vs oracle", ok))
    return rows


def _resume_row(rng, device) -> tuple[str, bool]:
    """A resume pass over a code list with a repeated code, cut to
    ``limit``: every copy of a code scores alike and ranks side by side."""
    k, sl, n, n_valid, limit = 9, 30, 64, 57, 7
    wins, texts = _pass_windows(rng, k, sl, n, n_valid)
    codes = [int(c) for c in rng.integers(0, 1 << (2 * k), 6)]
    for i in (0, 7, 14):  # k-mers of a count-3 window (an N read as T)
        codes.append(int("".join(map(str, np.minimum(wins[1, i:i + k], 3))), 4))
    codes.append(codes[-1])
    counts = oracle_error_count(texts, codes, k)
    ranked = [(c, n) for c, n in oracle_sort_compare_count(counts, k)
              for _ in range(codes.count(c))][:limit]
    engine = Engine(Params(k=k, sl=sl, limit=limit, param_lc=1.0), device)
    ac, acnt = engine.approx_stage(wins, n_valid,
                                   np.array(codes, dtype=np.uint64))
    return ("resume pass k= 9 (a repeated code) vs oracle",
            _pairs(ac, acnt) == ranked and len(codes) > limit)


def _mesh_step_row(rng, device) -> tuple[str, bool]:
    """``dist/mesh.py:full_step`` at world size 1: the multihost
    orchestrator's step (an engine built with ``sharded=True``, which at
    one rank runs the fused pass) on 121 valid rows of 512, against the
    oracle."""
    k, sl, n_valid, limit = 8, 24, 121, 37
    wins, texts = _pass_windows(rng, k, sl, 512, n_valid)
    counter, _ = oracle_count_kmers(texts, k, adjust_threshold(1.0, 16, k),
                                    set())
    sel = oracle_get_most_frequent(counter, limit, k)
    ranked = oracle_sort_compare_count(
        oracle_error_count(texts, [c for c, _ in sel], k), k)[:limit]
    engine = Engine(Params(k=k, sl=sl, limit=limit, param_lc=1.0), device,
                    sharded=True)
    (ec, ecnt), (ac, acnt), _ = full_step(engine, wins, n_valid)
    return ("mesh full step (all-reduced counts) vs oracle",
            _pairs(ec, ecnt) == sel and _pairs(ac, acnt) == ranked)


def _codec_rows(rng, device) -> list[tuple[str, bool]]:
    """The packed formats' round trips through the device unpackers, then
    ``Engine.device_windows`` on a sparse and a dense batch."""
    n, m, nv, ncols = 256, 101, 250, 100
    wb = np.full((n, m), BASE_PAD, np.uint8)
    wb[:nv, :ncols] = rng.integers(0, 4, (nv, ncols))
    for _ in range(57):
        wb[rng.integers(0, nv), rng.integers(0, ncols)] = BASE_N
    wb[0, 0] = wb[nv - 1, ncols - 1] = BASE_N
    lo, n_idx, got_ncols, _ = pack_windows_sparse(wb, nv)
    args = (torch.from_numpy(lo).to(device), torch.from_numpy(n_idx).to(device),
            nv, got_ncols, m)
    planes = torch.from_numpy(pack_windows_host(wb)[0]).to(device)
    rows = [
        ("sparse-N window unpack round trip",
         np.array_equal(unpack_windows_sparse(*args).cpu().numpy(), wb)),
        ("dense window unpack round trip",
         np.array_equal(unpack_windows(planes, m).cpu().numpy(), wb)),
        ("transposed sparse unpack round trip",
         np.array_equal(unpack_windows_sparse_t(*args).cpu().numpy(), wb.T)),
    ]
    engine = Engine(Params(k=8, sl=m - 1), device)
    dense = rng.integers(0, 4, (600, m)).astype(np.uint8)
    dense[rng.random(dense.shape) < 0.1] = BASE_N  # ~6,000 Ns > NCAP
    for what, batch, n_valid in (("sparse", wb, nv), ("dense", dense, 590)):
        windows_t, mask = engine.device_windows(batch, n_valid)
        rows.append((f"device_windows {what} upload round trip",
                     np.array_equal(windows_t.cpu().numpy(), batch.T)
                     and np.array_equal(mask.cpu().numpy(),
                                        np.arange(len(batch)) < n_valid)
                     and ((batch == BASE_N).sum() > NCAP) == (what == "dense")))
    return rows


def _pool_rows(rng, device) -> list[tuple[str, bool]]:
    """Pool passes at both ends: the start sl-prefix and end sl+1-suffix
    windows of 41 chosen reads, gathered on the device from the pool."""
    k, sl, n_reads, sn, limit = 8, 24, 60, 41, 37
    lens = rng.integers(2 * sl, 3 * sl, n_reads)
    buf = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    offs = np.zeros(n_reads + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    buf[rng.integers(0, len(buf), 15)] = BASE_N
    engine = Engine(Params(k=k, sl=sl, limit=limit, param_lc=1.0), device)
    built = engine.build_pool(Reads(buf=buf, offsets=offs), sl)
    chosen = rng.permutation(n_reads)[:sn]
    rows = []
    for end in (False, True):
        (ec, ecnt), (ac, acnt), stats = engine.start_pass_pool(
            chosen, sn, end=end).finish()
        texts = []
        for rid in chosen:
            s = buf[offs[rid]:offs[rid + 1]]
            texts.append(s[len(s) - 1 - sl:] if end else s[:sl])
        counter, had_n = oracle_count_kmers(
            texts, k, adjust_threshold(1.0, 16, k), set())
        sel = oracle_get_most_frequent(counter, limit, k)
        ranked = oracle_sort_compare_count(
            oracle_error_count(texts, [c for c, _ in sel], k), k)[:limit]
        rows.append((f"pool-path pass end={int(end)} vs oracle",
                     built and _pairs(ec, ecnt) == sel
                     and _pairs(ac, acnt) == ranked
                     and stats["had_n"] == had_n))
    return rows


def run(device=torch.device("cuda")) -> list[tuple[str, bool]]:
    """One (name, ok) row per check, on ``device``."""
    device = torch.device(device)
    rng = np.random.default_rng(99)
    rows = _kernel_rows(rng, device)
    rows.append(_exact_stage_row(rng, device))
    rows += _pass_rows(rng, device)
    rows.append(_resume_row(rng, device))
    rows.append(_mesh_step_row(rng, device))
    rows += _codec_rows(rng, device)
    rows += _pool_rows(rng, device)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("gpu_check: no CUDA device", file=sys.stderr)
        return 1
    rows = run()
    for name, ok in rows:
        print(f"{name}: {'OK' if ok else 'FAIL'}")
    fails = sum(not ok for _, ok in rows)
    print("GPU-CHECK " + ("PASS" if not fails else f"FAIL ({fails})"))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
