"""The comparison that decides ``correct``.

After the window, a sample of the passes that ran in it, drawn from the
run's seed, is worked out again by the plain reference
(``reference/adaptfinder.py``), from the same FASTA file and each job's
seed, and held to what the program wrote:

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
  it.

Every number is exact: its limit is 0.

A control or a planted fault takes the program's place through
``outputs``: the same numbers are read off what it writes.  The control
follows from the configuration's mode (``control_kind``).
"""

from __future__ import annotations

import re

import numpy as np

from benchmark.reference import adaptfinder as ref

LIMITS = dict(jobs_failed=0, passes_missing=0, stats_wrong=0, rows_wrong=0,
              unranked_wrong=0)

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


def program_output(job, p: int, stats: list) -> dict:
    """What the program wrote for pass ``p`` of ``job``: the approximate
    export's lines and the pass's printed numbers."""
    raw = job.exports[p]
    return dict(lines=[] if raw is None else raw.decode().splitlines(),
                stats=stats[p])


def control_output(windows: np.ndarray, prm, kind: str, device) -> dict:
    """The reference in the program's place with one guarantee broken:
    ``hamming`` counts substitutions only; ``first_cap`` cuts solid mode's
    selection at the program's first cap (512) instead of keeping every
    solid k-mer."""
    k, limit = prm.k, prm.limit
    cap = 512 if kind == "first_cap" else None
    ex = ref.exact_stage(windows, k, prm.param_lc, limit, prm.solid_km,
                         device, cap=cap)
    distance = "hamming" if kind == "hamming" else "edit"
    counts = ref.approx_counts(ex["codes"], windows, k, prm.max_error, device,
                               distance=distance)
    codes, counts = ref.rank(ex["codes"], counts, k, limit)
    return dict(lines=ref.export_lines(codes, counts, k),
                stats=dict(n_valid=len(windows), n_unique=ex["n_unique"],
                           n_keep=ex["n_keep"], had_n=ex["had_n"]))


def judge_pass(windows: np.ndarray, prm, out: dict, rng, sample: int,
               device) -> dict:
    """The numbers of one pass: ``stats_wrong`` (0 or 1), ``rows_wrong``
    and ``unranked_wrong``."""
    k, limit, solid = prm.k, prm.limit, prm.solid_km
    ex = ref.exact_stage(windows, k, prm.param_lc, limit, solid, device)
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
                    unranked_wrong=0)
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
                unranked_wrong=unranked)


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
    buf, offsets = ref.read_fasta(run.fasta)
    rng = np.random.default_rng(seed + 1)
    samplers = {}
    for j, p in picked:
        job = run.jobs[j]
        if job.rc != 0:
            nums["passes_missing"] += 1
            continue
        sampler = samplers.setdefault(j, ref.Sampler(buf, offsets, prm.sn,
                                                     prm.sl, job.seed))
        windows = sampler.windows(p, run.passes[p][1] == "end")
        if control is not None:
            out = control_output(windows, prm, control, run.device)
        elif outputs is not None:
            out = outputs[j, p]
        else:
            out = program_output(job, p, pass_stats(job.log, job.err,
                                                    n_passes))
        got = judge_pass(windows, prm, out, rng, SOLID_SAMPLE, run.device)
        for key, v in got.items():
            nums[key] += v
    if prm.solid_km == 0:
        del nums["unranked_wrong"]
    return nums


def correct(nums: dict) -> bool:
    return all(v <= LIMITS[key] for key, v in nums.items())
