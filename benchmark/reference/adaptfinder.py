"""Plain reference of one adaptFinder pass, in NumPy and PyTorch.

It follows the reference C++ (github.com/qbonenfant/approx_counter,
``approx_counter.cpp``) and imports nothing but NumPy and PyTorch, so it
shares no code with the program it judges:

- ``read_fasta``: records in file order, sequence lines joined, A/C/G/T
  (either case) to 0-3 and every other byte to N (4).
- ``Sampler``: the seeded sample of ``sampleSequences`` (:415-476) as the
  program draws it: one ``permutation`` of the read ids from
  ``numpy.random.default_rng(seed)`` per pass, in pass order (run 0 start,
  run 0 end, run 1 start, ...); the first ``sn`` reads of at least
  ``2 * sl`` bases in that order; start windows ``seq[:sl]``, end windows
  ``seq[len - 1 - sl:]`` (sl + 1 bases, the reference's off-by-one at
  :463); ``sn`` clamped to the read count first (:844-848).
- ``exact_stage``: ``count_kmers`` (:487-519): every k-mer of every window,
  those holding an N left out and tallied, those whose DUST score
  (``getComplexity`` :247-267, float32) reaches the adjusted threshold
  (:183-186, :790) left out, then the top ``limit`` in CompareCount order
  (:275-305: count descending, score ascending, code descending) or, in
  solid mode, every k-mer counted ``solid`` times or more (:372-388).
- ``approx_counts``: ``errorCount`` (:531-601) as its closed form: per
  candidate, the sum over windows of ``max(0, maxerr + 1 - d)``, ``d`` the
  least edit distance between the candidate and any substring of the
  window (Sellers' semi-global distance, by Myers' bit-vector algorithm;
  N matches nothing).  ``distance="hamming"`` counts substitutions only
  (the whole candidate against each window offset): a shortcut that breaks
  the configuration's edit-distance guarantee, one of the benchmark's
  controls.
- ``export_lines``: ``exportCounter`` (:157-174), ``kmer\\tcount`` lines.

Supports 3 <= k <= 32 (at k = 2 the reference divides by zero).
"""

from __future__ import annotations

import numpy as np
import torch

_ORD = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ORD[_c] = _i
    _ORD[_c + 32] = _i
_CHARS = np.frombuffer(b"ACGT", np.uint8)


def read_fasta(path: str):
    """``(buf, offsets)``: read i is ``buf[offsets[i]:offsets[i + 1]]``,
    as base ordinals (uint8, A=0 C=1 G=2 T=3 N=4)."""
    data = np.fromfile(path, np.uint8)
    ends = np.flatnonzero(data == ord("\n"))
    if len(data) and data[-1] != ord("\n"):
        ends = np.append(ends, len(data))
    starts = np.concatenate([[0], ends[:-1] + 1])
    header = data[starts] == ord(">")
    rec = np.cumsum(header) - 1
    seq_lines = np.flatnonzero(~header & (rec >= 0))
    edge = np.zeros(len(data) + 1, np.int8)
    np.add.at(edge, starts[seq_lines], 1)
    np.add.at(edge, ends[seq_lines], -1)
    mask = np.cumsum(edge[:-1], dtype=np.int8).view(bool) & (
        data != ord("\r"))
    buf = _ORD[data[mask]]
    # bases of each sequence line: the masked bytes in it
    upto = np.concatenate([[0], np.cumsum(mask)])
    line_bases = upto[ends[seq_lines]] - upto[starts[seq_lines]]
    per_rec = np.bincount(rec[seq_lines], weights=line_bases,
                          minlength=int(header.sum())).astype(np.int64)
    return buf, np.concatenate([[0], np.cumsum(per_rec)])


class Sampler:
    """The program's seeded sample, pass by pass (module docstring)."""

    def __init__(self, buf, offsets, sn: int, sl: int, seed: int):
        self.buf, self.offsets, self.sl = buf, offsets, sl
        self.lengths = np.diff(offsets)
        self.sn = min(sn, len(self.lengths))
        self.rng = np.random.default_rng(seed)
        self.taken = 0

    def windows(self, pass_index: int, end: bool) -> np.ndarray:
        """uint8 ``[n, sl]`` start or ``[n, sl + 1]`` end windows of pass
        ``pass_index``; passes are drawn in order, skipped ones too."""
        if pass_index < self.taken:
            raise ValueError("passes are drawn in order")
        while self.taken < pass_index:
            self.rng.permutation(len(self.lengths))
            self.taken += 1
        order = self.rng.permutation(len(self.lengths))
        self.taken += 1
        sl = self.sl
        chosen = order[self.lengths[order] >= 2 * sl][:self.sn]
        width = sl + 1 if end else sl
        first = (self.offsets[chosen + 1] - 1 - sl if end
                 else self.offsets[chosen])
        return self.buf[first[:, None] + np.arange(width)]


def adjusted_threshold(lc: float, k: int) -> np.float32:
    """``adjustThreshold`` (:183-186) from the k = 16 base, float32."""
    ratio = np.float32(float(k - 1) ** 2 / 15.0 ** 2)
    return np.float32(np.float32(lc) * ratio)


def score_table(k: int) -> np.ndarray:
    """``getComplexity``'s float32 score for each value of its integer
    numerator ``sum c (c - 1)`` (0 to (k - 1)(k - 2))."""
    s = np.arange((k - 1) * (k - 2) + 1, dtype=np.float32)
    return s / np.float32(2 * (k - 2))


def dust_numerator(codes: torch.Tensor, k: int) -> torch.Tensor:
    """``sum c (c - 1)`` over the counts ``c`` of the 16 dimers among the
    k - 1 dimers of each int64 code."""
    hist = torch.zeros((codes.numel(), 16), dtype=torch.int32,
                       device=codes.device)
    one = torch.ones((codes.numel(), 1), dtype=torch.int32,
                     device=codes.device)
    for j in range(k - 1):
        hist.scatter_add_(1, ((codes >> (2 * j)) & 15)[:, None], one)
    return (hist * (hist - 1)).sum(1)


def dust_score(codes: np.ndarray, k: int) -> np.ndarray:
    """``getComplexity`` (:247-267) of uint64 codes, float32."""
    s = dust_numerator(torch.from_numpy(codes.astype(np.uint64).view(
        np.int64)), k)
    return score_table(k)[s.numpy()]


def compare_count(codes: np.ndarray, counts: np.ndarray, k: int):
    """Indices putting (codes, counts) into CompareCount order."""
    codes = codes.astype(np.uint64)
    return np.lexsort((np.iinfo(np.uint64).max - codes, dust_score(codes, k),
                       -counts.astype(np.int64)))


def _kmer_codes(win: torch.Tensor, k: int):
    """Every k-mer code of ``[n, L]`` windows (int64, the uint64 bits) and
    whether it holds an N."""
    n, length = win.shape
    p = length - k + 1
    code = torch.zeros((n, p), dtype=torch.int64, device=win.device)
    has_n = torch.zeros((n, p), dtype=torch.bool, device=win.device)
    for j in range(k):
        sym = win[:, j:j + p].long()
        has_n |= sym > 3
        code = (code << 2) | (sym & 3)
    return code, has_n


def exact_stage(windows: np.ndarray, k: int, lc: float, limit: int,
                solid: int, device, cap: int | None = None) -> dict:
    """The exact count and selection of one pass: ``codes`` and ``counts``
    (uint64) of the selection in CompareCount order, ``n_unique`` (k-mers
    without an N, distinct), ``n_keep``, ``had_n``.  ``cap`` cuts the
    selection to its first ``cap`` (a control: solid mode without its
    guarantee)."""
    win = torch.from_numpy(windows).to(device)
    code, has_n = _kmer_codes(win, k)
    had_n = int(has_n.sum())
    uniq, cnt = torch.unique(code[~has_n], return_counts=True)
    n_unique = uniq.numel()
    table = torch.from_numpy(score_table(k)).to(device)
    low = table[dust_numerator(uniq, k)] >= float(adjusted_threshold(lc, k))
    uniq, cnt = uniq[~low], cnt[~low]
    if solid > 0:
        keep = cnt >= solid
    elif cnt.numel() > limit:
        keep = cnt >= torch.topk(cnt, limit).values[-1]
    else:
        keep = torch.ones_like(cnt, dtype=torch.bool)
    codes = uniq[keep].cpu().numpy().view(np.uint64)
    counts = cnt[keep].cpu().numpy()
    order = compare_count(codes, counts, k)
    if solid == 0:
        order = order[:limit]
    if cap is not None:
        order = order[:cap]
    return dict(codes=codes[order], counts=counts[order].astype(np.uint64),
                n_unique=n_unique, n_keep=len(order), had_n=had_n)


def _patterns(codes: np.ndarray, k: int) -> np.ndarray:
    """Bases of each code, first base first: ``[C, k]`` uint8."""
    codes = codes.astype(np.uint64)
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    return ((codes[:, None] >> shifts[None, :]) & np.uint64(3)).astype(
        np.uint8)


def _dmin_edit(pat: torch.Tensor, win: torch.Tensor, k: int) -> torch.Tensor:
    """Least semi-global edit distance, ``[C, n]``, by Myers' bit vectors
    (pattern position i is bit i; the text's start is free, so no carry
    enters the horizontal deltas)."""
    dev = win.device
    weights = 1 << torch.arange(k, device=dev, dtype=torch.int64)
    none = torch.zeros(len(pat), dtype=torch.int64, device=dev)
    peq = torch.stack([((pat == b).long() * weights).sum(1)
                       for b in range(4)] + [none], 1)   # N: no match
    mask, high = (1 << k) - 1, 1 << (k - 1)
    C, n = pat.shape[0], win.shape[0]
    pv = torch.full((C, n), mask, dtype=torch.int64, device=dev)
    mv = torch.zeros_like(pv)
    score = torch.full((C, n), k, dtype=torch.int16, device=dev)
    best = score.clone()
    for j in range(win.shape[1]):
        eq = peq[:, win[:, j].long()]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        score += ((ph & high) != 0).to(torch.int16)
        score -= ((mh & high) != 0).to(torch.int16)
        torch.minimum(best, score, out=best)
        ph = (ph << 1) & mask
        mh = (mh << 1) & mask
        pv = (mh | ~(xv | ph)) & mask
        mv = ph & xv
    return best


def _dmin_hamming(pat: torch.Tensor, win: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Least number of mismatches of the whole candidate against any
    offset of the window, ``[C, n]``."""
    C, n, length = pat.shape[0], win.shape[0], win.shape[1]
    best = torch.full((C, n), k, dtype=torch.int16, device=win.device)
    pat, win = pat.long(), win.long()
    for off in range(length - k + 1):
        miss = torch.zeros((C, n), dtype=torch.int16, device=win.device)
        for i in range(k):
            miss += (pat[:, i:i + 1] != win[None, :, off + i]).to(
                torch.int16)
        torch.minimum(best, miss, out=best)
    return best


def approx_counts(codes: np.ndarray, windows: np.ndarray, k: int,
                  maxerr: int, device, distance: str = "edit",
                  block: int = 256) -> np.ndarray:
    """``errorCount``'s total per candidate (uint64), ``block`` candidates
    at a time."""
    dmin = {"edit": _dmin_edit, "hamming": _dmin_hamming}[distance]
    win = torch.from_numpy(windows).to(device)
    pats = torch.from_numpy(_patterns(codes, k)).to(device)
    out = np.zeros(len(codes), np.uint64)
    for i in range(0, len(codes), block):
        d = dmin(pats[i:i + block], win, k)
        got = (maxerr + 1 - d.long()).clamp_(min=0).sum(1)
        out[i:i + block] = got.cpu().numpy().astype(np.uint64)
    return out


def decode(codes: np.ndarray, k: int) -> list[str]:
    """``int2dna`` (:70-78) of each code."""
    rows = _CHARS[_patterns(codes, k)]
    return [r.tobytes().decode("ascii") for r in rows]


def encode(kmers: list[str]) -> np.ndarray:
    """``dna2int`` (:55-62) of pure-ACGT k-mers of one length, uint64."""
    if not kmers:
        return np.zeros(0, np.uint64)
    bases = _ORD[np.frombuffer("".join(kmers).encode("ascii"), np.uint8)]
    bases = bases.reshape(len(kmers), -1).astype(np.uint64)
    if (bases > 3).any():
        raise ValueError("a k-mer holds a base other than A, C, G, T")
    code = np.zeros(len(kmers), np.uint64)
    for j in range(bases.shape[1]):
        code = (code << np.uint64(2)) | bases[:, j]
    return code


def export_lines(codes: np.ndarray, counts: np.ndarray, k: int) -> list[str]:
    """``exportCounter``'s lines (:157-174), without their newlines."""
    return [f"{km}\t{int(c)}" for km, c in zip(decode(codes, k), counts)]


def rank(codes: np.ndarray, counts: np.ndarray, k: int, limit: int):
    """``get_most_frequent`` on the approximate counts (:922-923): the
    first ``limit`` in CompareCount order."""
    order = compare_count(codes, counts, k)[:limit]
    return codes[order], counts[order]
