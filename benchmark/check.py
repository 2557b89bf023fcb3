"""The comparison that decides ``correct``.

After the window, a sample of the passes that ran in it, drawn from the
run's seed, is worked out again by the plain reference
(``reference/adaptfinder.py``), from the same FASTA file and each job's
seed, and held to what the program wrote (in a ``--multihost`` cell, rank
0's exports and log, the passes' windows the multihost sample of
``reference/multihost.py`` over every rank's files):

- ``jobs_failed``: jobs that returned another exit code than 0 or raised;
- ``passes_missing``: sampled passes that could not be judged;
- ``stats_wrong``: judged passes whose numbers in the program's log and
  warnings (k-mers with an N, distinct k-mers, k-mers kept, windows
  sampled; each where the program prints it) differ from the reference's;
- ``rows_wrong``: rows of the approximate export that differ from the
  reference's.  In top-N mode the reference makes the whole export and
  rows are compared line by line.  In solid mode it scores every exported
  k-mer (a row is wrong if its k-mer is not solid, its count is not the
  reference's, or it is out of CompareCount order) and counts missing or
  extra rows;
- ``unranked_wrong`` (solid mode): of a seeded sample of the solid k-mers
  the export left out, those that rank before its last row, so belong in
  it;
- ``exact_rows_wrong`` (where the configuration writes the exact-count
  export, ``-e``): rows of that export that differ from the reference's
  exact selection (its codes and counts in CompareCount order), compared
  row by row in order, plus missing and extra rows; a row that is not
  ``kmer\tcount`` as the reference prints it is wrong.  Both sides are
  compared as arrays, not as millions of formatted lines.

Every number is exact: its limit is 0.

A control or a planted fault takes the program's place through
``outputs``: the same numbers are read off what it writes.  The control
follows from the configuration's mode (``control_kind``).
"""

from __future__ import annotations

import re

import numpy as np

from benchmark.reference import adaptfinder as ref
from benchmark.reference import multihost as ref_multihost

LIMITS = dict(jobs_failed=0, passes_missing=0, stats_wrong=0, rows_wrong=0,
              unranked_wrong=0, exact_rows_wrong=0)

_STAMP = re.compile(r"^\[([0-9.e+-]+) ms\]")
_PASS = re.compile(r"Working on sequence (start|end)\.")
_STATS = {
    "n_valid": re.compile(r"Sampled (\d+) sequences"),
    "n_unique": re.compile(r"Number of kmer found: (\d+)"),
    "n_keep": re.compile(r"Number of kmer kept:\s+(\d+)"),
}
_HAD_N = re.compile(r"A total of (\d+) k-mers were ignored")


#: left-out solid k-mers a solid-mode pass scores for ``unranked_wrong``
SOLID_SAMPLE = 1000


def control_kind(prm) -> str:
    """The control of a configuration: ``first_cap`` in solid mode (the
    selection is what ``-sk`` guarantees), else ``hamming``."""
    return "first_cap" if prm.solid_km else "hamming"


def pass_stats(log: str, err: str, n_passes: int) -> list[dict]:
    """Each pass's numbers as the program printed them: from its log (one
    "Working on sequence" line opens each pass) and, for ``had_n``, from
    its N warnings, one per pass, when there is one for every pass."""
    out = [dict() for _ in range(n_passes)]
    i = -1
    for line in log.splitlines():
        if _PASS.search(line):
            i += 1
            continue
        if 0 <= i < n_passes:
            for key, pat in _STATS.items():
                m = pat.search(line)
                if m:
                    out[i][key] = int(m.group(1))
    had_n = [int(m) for m in _HAD_N.findall(err)]
    if len(had_n) == n_passes:
        for d, v in zip(out, had_n):
            d["had_n"] = v
    return out


def parse_ms(log: str):
    """Milliseconds from "Parsing FASTA file" to "Number of sequences
    found" in the program's log, or None."""
    t = {}
    for line in log.splitlines():
        m = _STAMP.match(line)
        if not m:
            continue
        if "Parsing FASTA file" in line:
            t["start"] = float(m.group(1))
        elif "Number of sequences found" in line and "start" in t:
            return float(m.group(1)) - t["start"]
    return None


def sample_passes(n_jobs: int, n_passes: int, count: int,
                  seed: int) -> list[tuple]:
    """``count`` distinct (job, pass) pairs, drawn from ``seed``, sorted."""
    total = n_jobs * n_passes
    picks = np.random.default_rng(seed).choice(total, min(count, total),
                                                replace=False)
    return sorted((int(p) // n_passes, int(p) % n_passes) for p in picks)


#: bytes to base codes in an export's k-mers; 255 for any other byte
_BASE = np.full(256, 255, np.uint8)
_BASE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def parse_export(raw: bytes, k: int):
    """An export's ``kmer\tcount`` rows as arrays: uint64 codes and
    counts, and whether each row is as the reference prints it (k bases of
    ACGT, a tab, a count of 1 to 19 digits without a leading zero, a
    newline).  A row that is not reads code and count 0."""
    data = np.frombuffer(raw, np.uint8)
    ends = np.flatnonzero(data == ord("\n"))
    if len(data) and data[-1] != ord("\n"):
        ends = np.append(ends, len(data))   # a last row without its newline
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
    ndig = ends - starts - k - 1
    pad = np.concatenate([data, np.zeros(k + 2, np.uint8)])
    ok = (ends < len(data)) & (ndig >= 1) & (ndig <= 19)
    ok &= pad[starts + k] == ord("\t")
    ok &= (pad[starts + k + 1] != ord("0")) | (ndig == 1)
    codes = np.zeros(len(ends), np.uint64)
    for j in range(k):       # a column at a time: 2.7 M rows an end
        base = _BASE[pad[starts + j]]
        ok &= base < 4
        codes = (codes << np.uint64(2)) | (base & 3).astype(np.uint64)
    counts = np.zeros(len(ends), np.uint64)
    width = int(ndig[ok].max()) if ok.any() else 0
    for j in range(width):   # the last ``width`` bytes before the newline
        at = ends - width + j
        inside = at > starts + k
        digit = pad[np.maximum(at, 0)].astype(np.int64) - ord("0")
        ok &= ~inside | ((digit >= 0) & (digit <= 9))
        counts = counts * np.uint64(10) + np.where(
            inside & ok, digit, 0).astype(np.uint64)
    codes[~ok] = 0
    counts[~ok] = 0
    return codes, counts, ok


def exact_rows_wrong(got, codes: np.ndarray, counts: np.ndarray) -> int:
    """Rows of an exact-count export (``parse_export``'s arrays, or None
    for a missing file) that differ from the reference's ``codes`` and
    ``counts``, row by row in order, plus missing and extra rows."""
    if got is None:
        return len(codes)
    g_codes, g_counts, ok = got
    n = min(len(g_codes), len(codes))
    same = ok[:n] & (g_codes[:n] == codes[:n]) & (g_counts[:n] == counts[:n])
    return int(n - same.sum()) + abs(len(g_codes) - len(codes))


def program_output(job, p: int, stats: list, k: int) -> dict:
    """What the program wrote for pass ``p`` of ``job``: the approximate
    export's lines, the pass's printed numbers and, where the job wrote
    exact-count exports, pass ``p``'s rows (``parse_export``)."""
    raw = job.exports[p]
    out = dict(lines=[] if raw is None else raw.decode().splitlines(),
               stats=stats[p])
    if job.exact_exports:
        exact = job.exact_exports[p]
        out["exact"] = None if exact is None else parse_export(exact, k)
    return out


def control_output(windows: np.ndarray, prm, kind: str, device) -> dict:
    """The reference in the program's place with one guarantee broken:
    ``hamming`` counts substitutions only; ``first_cap`` cuts solid mode's
    selection at the program's first cap (512) instead of keeping every
    solid k-mer.  Where the configuration writes the exact-count export,
    its rows are the control's exact selection."""
    k, limit = prm.k, prm.limit
    cap = 512 if kind == "first_cap" else None
    ex = ref.exact_stage(windows, k, prm.param_lc, limit, prm.solid_km,
                         device, cap=cap)
    distance = "hamming" if kind == "hamming" else "edit"
    counts = ref.approx_counts(ex["codes"], windows, k, prm.max_error, device,
                               distance=distance)
    codes, counts = ref.rank(ex["codes"], counts, k, limit)
    out = dict(lines=ref.export_lines(codes, counts, k),
               stats=dict(n_valid=len(windows), n_unique=ex["n_unique"],
                          n_keep=ex["n_keep"], had_n=ex["had_n"]))
    if prm.exact_out:
        out["exact"] = (ex["codes"], ex["counts"],
                        np.ones(len(ex["codes"]), bool))
    return out


def judge_pass(windows: np.ndarray, prm, out: dict, rng, sample: int,
               device) -> dict:
    """The numbers of one pass: ``stats_wrong`` (0 or 1), ``rows_wrong``
    and ``unranked_wrong``, and ``exact_rows_wrong`` where ``out`` holds
    exact-count rows (``exact``)."""
    k, limit, solid = prm.k, prm.limit, prm.solid_km
    ex = ref.exact_stage(windows, k, prm.param_lc, limit, solid, device)
    exact = {} if "exact" not in out else dict(exact_rows_wrong=(
        exact_rows_wrong(out["exact"], ex["codes"], ex["counts"])))
    want = dict(n_valid=len(windows), n_unique=ex["n_unique"],
                n_keep=ex["n_keep"], had_n=ex["had_n"])
    got = out["stats"]
    stats_wrong = int("had_n" not in got
                      or any(got[key] != want[key] for key in got))
    lines = out["lines"]
    if solid == 0:
        counts = ref.approx_counts(ex["codes"], windows, k, prm.max_error,
                                   device)
        codes, counts = ref.rank(ex["codes"], counts, k, limit)
        expect = ref.export_lines(codes, counts, k)
        rows = sum(a != b for a, b in zip(lines, expect))
        return dict(stats_wrong=stats_wrong,
                    rows_wrong=rows + abs(len(lines) - len(expect)),
                    unranked_wrong=0, **exact)
    rows = abs(len(lines) - min(ex["n_keep"], limit))
    kmers, counts = [], []
    for line in lines:
        km, _, c = line.partition("\t")
        if len(km) == k and set(km) <= set("ACGT") and c.isdigit():
            kmers.append(km)
            counts.append(int(c))
        else:
            rows += 1
    codes = ref.encode(kmers)
    counts = np.array(counts, np.uint64)
    solid_set = ex["codes"]
    in_set = np.isin(codes, solid_set)
    truth = np.zeros(len(codes), np.uint64)
    truth[in_set] = ref.approx_counts(codes[in_set], windows, k,
                                      prm.max_error, device)
    ok = in_set & (counts == truth)
    order = ref.compare_count(codes, truth, k)
    ok &= order == np.arange(len(codes))
    rows += int((~ok).sum())
    unranked = 0
    left_out = solid_set[~np.isin(solid_set, codes)]
    if len(codes) and len(left_out):
        pick = left_out[rng.choice(len(left_out), min(sample, len(left_out)),
                                   replace=False)]
        scored = ref.approx_counts(pick, windows, k, prm.max_error, device)
        both = np.concatenate([codes[-1:], pick])
        order = ref.compare_count(both, np.concatenate([truth[-1:], scored]),
                                  k)
        unranked = int(np.flatnonzero(order == 0)[0])
    return dict(stats_wrong=stats_wrong, rows_wrong=rows,
                unranked_wrong=unranked, **exact)


def samplers(run):
    """A function from a job's seed to the reference's sampler of that job
    (``windows(i, end)``): in a ``--multihost`` run the multihost sample of
    the run's input files at the cell's ranks (``reference/multihost.py``,
    ``i`` the run), else the single-device one (``i`` the pass)."""
    prm = run.prm
    paths = run.fasta.split(",")
    if prm.multihost:
        files = [ref.read_fasta(path) for path in paths]
        return lambda seed: ref_multihost.Sampler(
            files, run.cell.chips, prm.sn, prm.sl, seed)
    buf, offsets = ref.read_fasta(paths[0])
    return lambda seed: ref.Sampler(buf, offsets, prm.sn, prm.sl, seed)


def judge(run, outputs=None, control: str | None = None) -> dict:
    """The compared numbers of ``run`` (``harness.Run``).  ``outputs``
    maps (job, pass) to what stands in the program's place; by default
    what the program wrote, or, given ``control``, the control's
    output."""
    prm = run.prm
    n_passes = len(run.passes)
    seed = run.derive(1 << 20)
    picked = sample_passes(len(run.jobs), n_passes,
                           run.cell.workload["check_passes"], seed)
    nums = dict(jobs_failed=sum(j.rc != 0 for j in run.jobs),
                passes_missing=0, stats_wrong=0, rows_wrong=0,
                unranked_wrong=0)
    if prm.exact_out:
        nums["exact_rows_wrong"] = 0
    sampler_of = samplers(run)
    rng = np.random.default_rng(seed + 1)
    made = {}
    for j, p in picked:
        job = run.jobs[j]
        if job.rc != 0:
            nums["passes_missing"] += 1
            continue
        if j not in made:
            made = {j: sampler_of(job.seed)}
        r, end = run.passes[p]
        windows = made[j].windows(r if prm.multihost else p, end == "end")
        if control is not None:
            out = control_output(windows, prm, control, run.device)
        elif outputs is not None:
            out = outputs[j, p]
        else:
            out = program_output(job, p, pass_stats(job.log, job.err,
                                                    n_passes), prm.k)
        got = judge_pass(windows, prm, out, rng, SOLID_SAMPLE, run.device)
        for key, v in got.items():
            nums[key] += v
    if prm.solid_km == 0:
        del nums["unranked_wrong"]
    return nums


def correct(nums: dict) -> bool:
    return all(v <= LIMITS[key] for key, v in nums.items())
