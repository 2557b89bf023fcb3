"""Approximate counts of candidate k-mers against sampled windows.

Port of ``approx_counter_tpu/kernels/bpm.py``.  For every candidate k-mer c
the count is the sum over valid windows w of

    max(0, maxerr + 1 - d_min(c, w))

where d_min is the least edit distance between c and any substring of w
(the reference's per-error-level counting, approx_counter.cpp:531-601).
Window symbols >= 4 (N, pad) match no candidate base.

Four CUDA kernels compute that function, each behind its own wrapper:

  * ``approx_counts`` -> ``csrc/nfa_sliced.cu``, the candidate-bit-sliced
    level NFA that replaces the Pallas kernel ``_nfa_kernel_sliced``.  The
    CLI's kernel at every k and maxerr, as in the JAX package's dispatch.
  * ``approx_counts_myers`` -> ``csrc/bpm_myers.cu``, unpacked Myers
    (replaces ``_bpm_kernel``).
  * ``approx_counts_packed(algo="myers")`` -> ``csrc/bpm_packed.cu``, Myers
    from SWAR words of 2 or 4 candidates (replaces ``_bpm_kernel_packed``).
    Both Myers kernels take their candidates apart into bit planes, 32 a
    word, and run one candidate-bit-sliced core (``csrc/myers_sliced.cuh``).
  * ``approx_counts_packed(algo="nfa")`` -> ``csrc/nfa_packed.cu``, the
    level NFA from SWAR words of 1-16 candidates (replaces
    ``_nfa_kernel_packed``).  It takes its candidates apart into bit planes
    and runs the sliced NFA's core (``csrc/nfa_sliced.cuh``).

The last three are differential alternates: ``gpu_check`` holds them
against the plain versions on the card.  The plain versions:

  * ``approx_counts_ref`` -- Myers' 1999 bit-vector DP, one 32-bit word per
    (candidate, window), a twin of the JAX package's ``approx_counts_jnp``.
    The plain version of the sliced and the unpacked Myers kernels.
  * ``approx_counts_packed_ref`` -- the SWAR Myers and SWAR level NFA step
    for step, the plain version of the two packed kernels.
  * ``approx_counts_myers_sliced_ref`` and ``approx_counts_nfa_sliced_ref``
    -- the bit-sliced Myers and level-NFA cores step for step, which the
    tests and ``chip_smoke.py`` hold the kernels on each core against
    beside the two above.

Each wrapper dispatches on the tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors, and nothing else.

Candidate bit-vectors are int64 tensors holding uint32 values (torch's
uint32 lacks shifts and arithmetic on the CPU); the Myers scan masks to 32
bits wherever uint32 wraparound matters.
"""

from __future__ import annotations

import torch

MAXERR = 2  # reference default (approx_counter.cpp:25)
_M32 = 0xFFFFFFFF


def build_peq(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Per-candidate Myers Peq masks, int64 [C, 4] holding uint32 values.

    Bit i (LSB = first pattern base) of ``peq[c, b]`` is set iff pattern
    base i == b.  Pattern bases decode from the packed code high bits first
    (approx_counter.cpp:55-62).
    """
    pos = torch.arange(k, dtype=torch.int64, device=codes.device)
    base = (codes[:, None] >> (2 * (k - 1 - pos))[None, :]) & 3   # [C, k]
    weight = (1 << pos)[None, :]
    return torch.stack(
        [((base == b) * weight).sum(dim=1) for b in range(4)], dim=1
    )


def build_sliced_planes(peq: torch.Tensor, k: int):
    """Candidate bit-planes for the sliced NFA and the plain bit-sliced
    Myers core: [C, 4] peq -> (P0, P1), each int64 [C // 32, k] holding
    uint32 values.

    Bit c of ``P0[w, i]`` is bit 0 of candidate (32w + c)'s base at pattern
    position i (base in {C, T}); ``P1`` is bit 1 (base in {G, T}).  C must
    be a multiple of 32 (callers pad with zero peq rows).
    """
    C = peq.shape[0]
    if C % 32:
        raise ValueError(f"build_sliced_planes needs C % 32 == 0, got {C}")
    pos = torch.arange(k, dtype=torch.int64, device=peq.device)
    lane = torch.arange(32, dtype=torch.int64, device=peq.device)

    def bitslice(mask):
        bits = (mask[:, None] >> pos[None, :]) & 1                 # [C, k]
        return (bits.reshape(C // 32, 32, k) << lane[None, :, None]).sum(dim=1)

    return bitslice(peq[:, 1] | peq[:, 3]), bitslice(peq[:, 2] | peq[:, 3])


#: Windows per block of the plain scan on the CPU: a [C, W] state far
#: larger than the caches, as at the default run's W, leaves the whole-batch
#: scan waiting on memory.
CPU_BLOCK = 256


def approx_counts_ref(peq: torch.Tensor, windows_t: torch.Tensor,
                      window_valid: torch.Tensor, k: int,
                      maxerr: int = MAXERR) -> torch.Tensor:
    """Plain torch version: Myers' bit-vector DP over the text rows, on the
    CPU in blocks of ``CPU_BLOCK`` windows (counts are sums over windows).

    peq:          int64 [C, 4]
    windows_t:    uint8 [m, W] (transposed windows)
    window_valid: bool [W]
    returns       int32 [C]
    """
    W = windows_t.shape[1]
    if peq.device.type == "cpu" and W > CPU_BLOCK:
        return sum(_myers_scan(peq, windows_t[:, w:w + CPU_BLOCK],
                               window_valid[w:w + CPU_BLOCK], k, maxerr)
                   for w in range(0, W, CPU_BLOCK))
    return _myers_scan(peq, windows_t, window_valid, k, maxerr)


def _myers_scan(peq, windows_t, window_valid, k, maxerr):
    C = peq.shape[0]
    m, W = windows_t.shape
    dev = peq.device
    # one all-zero column per symbol >= 4: N and pad match nothing
    peq6 = torch.cat([peq, torch.zeros((C, 2), dtype=torch.int64, device=dev)], 1)
    VP = torch.full((C, W), _M32, dtype=torch.int64, device=dev)
    VN = torch.zeros((C, W), dtype=torch.int64, device=dev)
    score = torch.full((C, W), k, dtype=torch.int64, device=dev)
    minsc = score.clone()
    # every step in place: on the CPU a step's [C, W] temporaries cost more
    # than its arithmetic
    Xv, Xh, Ph, Mh, bit = (torch.empty_like(VP) for _ in range(5))
    rows = windows_t.to(torch.int64)
    for j in range(m):
        Eq = peq6.index_select(1, rows[j])
        torch.bitwise_or(Eq, VN, out=Xv)
        # Xh = ((((Eq & VP) + VP) & M32) ^ VP) | Eq
        torch.bitwise_and(Eq, VP, out=Xh)
        Xh += VP
        Xh &= _M32
        Xh ^= VP
        Xh |= Eq
        # Ph = VN | (~(Xh | VP) & M32);  Mh = VP & Xh
        torch.bitwise_or(Xh, VP, out=Ph).bitwise_not_()
        Ph &= _M32
        Ph |= VN
        torch.bitwise_and(VP, Xh, out=Mh)
        # score += bit k-1 of Ph - bit k-1 of Mh
        torch.bitwise_right_shift(Ph, k - 1, out=bit)
        score += bit.bitwise_and_(1)
        torch.bitwise_right_shift(Mh, k - 1, out=bit)
        score -= bit.bitwise_and_(1)
        Ph <<= 1
        Ph &= _M32
        Mh <<= 1
        Mh &= _M32
        # VP = Mh | (~(Xv | Ph) & M32);  VN = Ph & Xv
        torch.bitwise_or(Xv, Ph, out=VP).bitwise_not_()
        VP &= _M32
        VP |= Mh
        torch.bitwise_and(Ph, Xv, out=VN)
        torch.minimum(minsc, score, out=minsc)
    contrib = (maxerr + 1 - minsc).clamp_(min=0) * window_valid[None, :]
    return contrib.sum(dim=1).to(torch.int32)


def interleave_peq(peq: torch.Tensor, pack: int) -> torch.Tensor:
    """[C, 4] peq -> [ceil(C / pack), 4] SWAR words, int64 holding uint32.

    Word i holds candidates pack*i ... pack*i + pack - 1; candidate
    pack*i + f sits in the bits [fw*f, fw*f + fw), fw = 32 // pack.  C is
    padded to a multiple of ``pack`` with zero rows (poly-A candidates whose
    counts the callers slice off).
    """
    C = peq.shape[0]
    c_pad = -(-C // pack) * pack
    if c_pad != C:
        peq = torch.cat([peq, peq.new_zeros((c_pad - C, 4))])
    shift = (32 // pack) * torch.arange(pack, device=peq.device)
    return (peq.reshape(c_pad // pack, pack, 4) << shift[None, :, None]).sum(dim=1)


def _check_packed(k: int, pack: int, algo: str) -> None:
    # Myers needs a guard bit per field, shown right for 2 and 4 fields;
    # the NFA has no carries and packs down to 2-bit fields.
    packs = {"myers": (2, 4), "nfa": (1, 2, 4, 8, 16)}
    if algo not in packs or pack not in packs[algo] or k > 32 // pack:
        raise ValueError(f"no packed {algo!r} kernel for pack={pack}, k={k}: "
                         f"myers takes pack 2 or 4, nfa 1, 2, 4, 8 or 16, "
                         f"and k <= 32 // pack")


def approx_counts_packed_ref(peq: torch.Tensor, windows_t: torch.Tensor,
                             window_valid: torch.Tensor, k: int,
                             maxerr: int = MAXERR, pack: int = 2,
                             algo: str = "myers") -> torch.Tensor:
    """Plain torch version of the two SWAR kernels, step for step as the
    JAX package's ``_bpm_kernel_packed`` / ``_nfa_kernel_packed``: ``pack``
    candidates per 32-bit word (``interleave_peq``), int64 masked to 32
    bits.  Same arguments and result as ``approx_counts_ref``.

    ``algo="myers"``: Myers' DP with a per-field add that drops the carry
    out of each field, a ``LEAK`` mask after each left shift, one packed
    score (each field's +-1 at its bit 0) and a per-field running minimum.
    ``algo="nfa"``: the level NFA R_0..R_maxerr with no leak masks (every
    bit a shift carries into the next field lands on a bit the recurrence
    forces) and ``| ONES`` on level 1 only; ``h`` ORs each level's states
    from the initial state on, and a window adds the levels whose bit k-1
    was ever set.
    """
    _check_packed(k, pack, algo)
    C = peq.shape[0]
    m, W = windows_t.shape
    dev = peq.device
    fw = 32 // pack
    ones = sum(1 << (fw * f) for f in range(pack))
    fmask = (1 << fw) - 1
    words = interleave_peq(peq, pack)
    n_words = words.shape[0]
    mask0 = (words[:, 1] | words[:, 3])[:, None]   # pattern bases with bit 0
    mask1 = (words[:, 2] | words[:, 3])[:, None]   # pattern bases with bit 1

    def full(value):
        return torch.full((n_words, W), value, dtype=torch.int64, device=dev)

    def eq_row(j):
        c = windows_t[j].to(torch.int64)[None, :]
        x0 = ((c & 1) - 1) & _M32          # all ones iff text bit 0 == 0
        x1 = (((c >> 1) & 1) - 1) & _M32   # all ones iff text bit 1 == 0
        vm = ((c - 4) >> 63) & _M32        # N and pad match nothing
        return (mask0 ^ x0) & (mask1 ^ x1) & vm

    if algo == "myers":
        H = ones << (fw - 1)               # top bit of each field
        NH, LEAK = H ^ _M32, ones ^ _M32
        VP, VN, score = full(_M32), full(0), full(k * ones)
        mins = [full(k) for _ in range(pack)]
        for j in range(m):
            Eq = eq_row(j)
            Xv = Eq | VN
            a = Eq & VP
            add = ((a & NH) + (VP & NH)) ^ ((a ^ VP) & H)
            Xh = (add ^ VP) | Eq
            Ph = VN | (~(Xh | VP) & _M32)
            Mh = VP & Xh
            score += ((Ph >> (k - 1)) & ones) - ((Mh >> (k - 1)) & ones)
            for f, mn in enumerate(mins):
                torch.minimum(mn, (score >> (fw * f)) & fmask, out=mn)
            Ph = (Ph << 1) & LEAK
            Mh = (Mh << 1) & LEAK
            VP = Mh | (~(Xv | Ph) & _M32)
            VN = Ph & Xv
        hits = [(maxerr + 1 - mn).clamp_(min=0) for mn in mins]
    else:
        # R_d(0) bit i = [i < d], cut to the field width (pack 8 and 16)
        R = [full(((((1 << d) - 1) & fmask) * ones) & _M32)
             for d in range(maxerr + 1)]
        h = [r.clone() for r in R]
        for j in range(m):
            Eq = eq_row(j)
            S = [(r << 1) & _M32 for r in R]
            Rn = [(S[0] | ones) & Eq]
            for d in range(1, maxerr + 1):
                nxt = (S[d] & Eq) | R[d - 1] | S[d - 1] | ((Rn[d - 1] << 1) & _M32)
                Rn.append(nxt | ones if d == 1 else nxt)
            R = Rn
            h = [hh | rr for hh, rr in zip(h, R)]
        hits = [sum((hd >> (fw * f + k - 1)) & 1 for hd in h) for f in range(pack)]
    counts = torch.stack([(x * window_valid[None, :]).sum(dim=1) for x in hits], 1)
    return counts.reshape(n_words * pack)[:C].to(torch.int32)


def approx_counts_myers_sliced_ref(peq: torch.Tensor, windows_t: torch.Tensor,
                                   window_valid: torch.Tensor, k: int,
                                   maxerr: int = MAXERR) -> torch.Tensor:
    """Plain torch version of the candidate-bit-sliced Myers core
    (``csrc/myers_sliced.cuh``, behind ``bpm_myers.cu`` and
    ``bpm_packed.cu``), step for step: 32 candidates a word
    (``build_sliced_planes``, C padded with zero rows), k planes of VP and
    VN per word and window, int64 holding uint32.  Per text symbol, planes
    in order, Mh of plane i-1 is both the carry into plane i's add and the
    shifted Mh, Ph of plane i-1 the shifted Ph; the score is a bit-sliced
    up/down counter of ``k.bit_length()`` planes, and h_d gathers
    [score <= d] for d = 0-3.  Same arguments and result as
    ``approx_counts_ref``."""
    C = peq.shape[0]
    m, W = windows_t.shape
    dev = peq.device
    c_pad = -(-C // 32) * 32
    if c_pad != C:  # zero rows decode as poly-A: garbage counts, sliced off
        peq = torch.cat([peq, peq.new_zeros((c_pad - C, 4))])
    P0, P1 = build_sliced_planes(peq, k)          # [n_words, k] each
    n_words = c_pad // 32

    def full(value):
        return torch.full((n_words, W), value, dtype=torch.int64, device=dev)

    VP = [full(_M32) for _ in range(k)]
    VN = [full(0) for _ in range(k)]
    s = [full(_M32 if (k >> j) & 1 else 0) for j in range(k.bit_length())]
    h = [full(_M32 if d >= k else 0) for d in range(4)]
    for j in range(m):
        c = windows_t[j].to(torch.int64)[None, :]
        x0 = ((c & 1) - 1) & _M32          # all ones iff text bit 0 == 0
        x1 = (((c >> 1) & 1) - 1) & _M32   # all ones iff text bit 1 == 0
        vm = ((c - 4) >> 63) & _M32        # N and pad match nothing
        ph = mh = 0                        # Ph and Mh of plane i-1
        for i in range(k):
            eq = (P0[:, i:i + 1] ^ x0) & (P1[:, i:i + 1] ^ x1) & vm
            xh = eq | mh
            xv = eq | VN[i]
            ph_i = VN[i] | ((xh | VP[i]) ^ _M32)
            mh_i = VP[i] & xh
            VP[i] = mh | ((xv | ph) ^ _M32)
            VN[i] = ph & xv
            ph, mh = ph_i, mh_i
        toggle = ph | mh                   # +1 at ph, -1 at mh
        for b, bit in enumerate(s):
            s[b] = bit ^ toggle
            toggle = toggle & ((bit ^ ph) ^ _M32)
        low = _M32                         # score <= 3
        for bit in s[2:]:
            low = low & (bit ^ _M32)
        h[0] = h[0] | (low & ((s[1] | s[0]) ^ _M32))
        h[1] = h[1] | (low & (s[1] ^ _M32))
        h[2] = h[2] | (low & ((s[1] & s[0]) ^ _M32))
        h[3] = h[3] | low
    lane = torch.arange(32, dtype=torch.int64, device=dev)[None, :, None]
    counts = sum((((hd[:, None, :] >> lane) & 1) * window_valid).sum(dim=2)
                 for hd in h[:maxerr + 1])
    return counts.reshape(c_pad)[:C].to(torch.int32)


#: Text symbols: bases 0-3, N 4, pad 5 (``core/codec.py``).
N_SYMBOLS = 6


def build_match_table(P0: torch.Tensor, P1: torch.Tensor) -> torch.Tensor:
    """The sliced level-NFA core's match table from the base bit-planes
    (``build_sliced_planes``): int64 [N_SYMBOLS, n_words, k] holding uint32
    values.  Bit c of ``table[s, w, i]`` is set iff candidate (32w + c)'s
    base at pattern position i is s; rows 4 (N) and 5 (pad) are zero, so
    those symbols match nothing."""
    rows = []
    for s in range(4):
        x0 = ((s & 1) - 1) & _M32          # all ones iff bit 0 of s == 0
        x1 = (((s >> 1) & 1) - 1) & _M32   # all ones iff bit 1 of s == 0
        rows.append((P0 ^ x0) & (P1 ^ x1))
    return torch.stack(rows + [torch.zeros_like(P0)] * (N_SYMBOLS - 4))


def approx_counts_nfa_sliced_ref(peq: torch.Tensor, windows_t: torch.Tensor,
                                 window_valid: torch.Tensor, k: int,
                                 maxerr: int = MAXERR) -> torch.Tensor:
    """Plain torch version of the candidate-bit-sliced level-NFA core
    (``csrc/nfa_sliced.cuh``, behind ``nfa_sliced.cu`` and
    ``nfa_packed.cu``), step for step: 32 candidates a word
    (``build_sliced_planes``, C padded with zero rows), one state word
    R[d][i] per level d <= min(maxerr, k - 1) and pattern position i >= d
    (positions i < d are the all-ones constant), int64 holding uint32.  Per
    text symbol c (0-5), Eq[i] is row c of the word's match table
    (``build_match_table``), Rn_0[i] = R_0[i-1] & Eq[i] and
    Rn_d[i] = (R_d[i-1] & Eq[i]) | R_{d-1}[i] | R_{d-1}[i-1] | Rn_{d-1}[i-1],
    the shifts of the word form being the index i - 1; h_d gathers
    Rn_d[k-1].  Levels above k - 1 hit every valid window.  Same arguments
    and result as ``approx_counts_ref``, for windows of symbols 0-5."""
    C = peq.shape[0]
    m, W = windows_t.shape
    dev = peq.device
    c_pad = -(-C // 32) * 32
    if c_pad != C:  # zero rows decode as poly-A: garbage counts, sliced off
        peq = torch.cat([peq, peq.new_zeros((c_pad - C, 4))])
    # [k, n_words, N_SYMBOLS]: position i's masks of every symbol
    table = build_match_table(*build_sliced_planes(peq, k)).permute(2, 1, 0)
    n_words = c_pad // 32
    levels = min(maxerr, k - 1) + 1
    zero = torch.zeros((n_words, W), dtype=torch.int64, device=dev)
    R = [[zero] * k for _ in range(levels)]       # entries i < d unread
    h = [zero] * levels
    for j in range(m):
        c = windows_t[j].to(torch.int64)
        eq = [table[i][:, c] for i in range(k)]
        Rn = [[eq[0]] + [R[0][i - 1] & eq[i] for i in range(1, k)]]
        for d in range(1, levels):
            row = [zero] * d
            for i in range(d, k):
                match = eq[i] & R[d][i - 1] if i > d else eq[i]
                row.append(match | R[d - 1][i] | R[d - 1][i - 1]
                           | Rn[d - 1][i - 1])
            Rn.append(row)
        R = Rn
        h = [hd | r[k - 1] for hd, r in zip(h, R)]
    lane = torch.arange(32, dtype=torch.int64, device=dev)[None, :, None]
    counts = sum((((hd[:, None, :] >> lane) & 1) * window_valid).sum(dim=2)
                 for hd in h)
    # levels above k - 1: the alignment to the empty substring
    counts = counts + (maxerr + 1 - levels) * window_valid.sum()
    return counts.reshape(c_pad)[:C].to(torch.int32)


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _check_inputs(peq, windows_t, window_valid, k, maxerr):
    if not (2 <= k <= 32 and 0 <= maxerr <= 3):
        raise ValueError(f"k={k}, maxerr={maxerr}: need 2<=k<=32, 0<=maxerr<=3")
    if peq.dtype != torch.int64 or peq.dim() != 2 or peq.shape[1] != 4:
        raise ValueError(f"peq must be int64 [C, 4], got {peq.dtype} "
                         f"{tuple(peq.shape)}")
    if windows_t.dtype != torch.uint8 or windows_t.dim() != 2:
        raise ValueError(f"windows_t must be uint8 [m, W], got "
                         f"{windows_t.dtype} {tuple(windows_t.shape)}")
    if (window_valid.dtype != torch.bool
            or tuple(window_valid.shape) != (windows_t.shape[1],)):
        raise ValueError(f"window_valid must be bool [W], got "
                         f"{window_valid.dtype} {tuple(window_valid.shape)}")
    if not (windows_t.is_contiguous() and window_valid.is_contiguous()):
        raise ValueError("windows_t and window_valid must be contiguous")
    if not (peq.device == windows_t.device == window_valid.device):
        raise ValueError("peq, windows_t and window_valid must share a device")


def _on_cpu(t: torch.Tensor, fn: str) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel); anything else raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cpu"


def _launch(fn, tensors, ints) -> None:
    """Call the C entry ``fn`` of a kernel library on the tensors' device
    and current stream (a tensor given as None passes a null pointer); a
    nonzero CUDA error raises."""
    dev = tensors[0].device
    with torch.cuda.device(dev):
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors),
                *ints, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {rc}")


#: Most candidate groups one launch takes: every kernel puts its groups on
#: ``grid.y``, which CUDA caps at 65,535 blocks.
MAX_GRID_Y = 65535
#: Candidates of one ``grid.y`` block of the kernels on a bit-sliced core
#: (``kCands`` in ``csrc/myers_sliced.cuh`` and ``csrc/nfa_sliced.cuh``):
#: ``bpm_myers.cu`` takes that many candidates, ``bpm_packed.cu`` and
#: ``nfa_packed.cu`` that many over ``pack`` words.
SLICED_CANDS = 32


def word_launches(n_words: int, group: int = 1) -> list[tuple[int, int]]:
    """(first word, word count) of each launch for ``n_words`` rows of a
    kernel that takes ``group`` rows per ``grid.y`` block: one launch up to
    ``MAX_GRID_Y`` groups, then consecutive slices of at most that many.
    The rows are the sliced NFA's 32-candidate words (group 1), unpacked
    Myers' candidates (group ``SLICED_CANDS``) and the two packed kernels'
    SWAR words (group ``SLICED_CANDS // pack``)."""
    step = MAX_GRID_Y * group
    return [(w, min(step, n_words - w)) for w in range(0, n_words, step)]


def approx_counts(peq: torch.Tensor, windows_t: torch.Tensor,
                  window_valid: torch.Tensor, k: int,
                  maxerr: int = MAXERR) -> torch.Tensor:
    """int32 [C] approximate counts: the sliced level NFA
    (``csrc/nfa_sliced.cu``) for CUDA tensors, the plain version for CPU
    tensors.  Window symbols are 0-5: the kernel reads each from a six-row
    match table.  Any C: past 65,535 words (2,097,120 candidates) the words
    are split over several launches (``word_launches``), each writing its
    own slice of the counts.  ``approx_counts.launches`` counts the kernel
    launches."""
    _check_inputs(peq, windows_t, window_valid, k, maxerr)
    C = peq.shape[0]
    m, W = windows_t.shape
    if C == 0 or W == 0:
        return torch.zeros(C, dtype=torch.int32, device=peq.device)
    if _on_cpu(peq, "approx_counts"):
        return approx_counts_ref(peq, windows_t, window_valid, k, maxerr)

    from approx_counter_tpu_torch.kernels._build import nfa_sliced_build

    c_pad = -(-C // 32) * 32
    if c_pad != C:  # zero rows decode as poly-A: garbage counts, sliced off
        peq = torch.cat([peq, peq.new_zeros((c_pad - C, 4))])
    p0, p1 = (_as_int32_bits(p).contiguous() for p in build_sliced_planes(peq, k))
    out = torch.zeros(c_pad, dtype=torch.int32, device=peq.device)
    fn = nfa_sliced_build(k, maxerr).lib.nfa_sliced
    for w0, n in word_launches(c_pad // 32):
        _launch(fn, (p0[w0:w0 + n], p1[w0:w0 + n], windows_t, window_valid,
                     out[32 * w0:32 * (w0 + n)]), (n, m, W))
        approx_counts.launches += 1
    return out[:C]


approx_counts.launches = 0


def approx_counts_myers(peq: torch.Tensor, windows_t: torch.Tensor,
                        window_valid: torch.Tensor, k: int,
                        maxerr: int = MAXERR) -> torch.Tensor:
    """int32 [C] approximate counts by unpacked Myers: ``csrc/bpm_myers.cu``
    for CUDA tensors, ``approx_counts_ref`` for CPU tensors.  Any C: past
    65,535 groups of 32 (2,097,120 candidates) the candidates are split over
    several launches (``word_launches``).  ``approx_counts_myers.launches``
    counts the kernel launches.

    The counterpart of the JAX package's ``approx_counts_pallas``.  Its
    knobs do not carry over: ``ct``/``wt`` size VMEM tiles of the TPU's
    sequential grid (a CUDA block here is 256 windows by 32 candidates, and
    ragged edges are masked in the kernel), ``eqsel`` chose between two TPU
    vector-unit idioms (the kernel always takes the base-bit select), and
    ``interpret`` ran the Pallas body on the CPU (the plain version is the
    CPU path here).
    """
    _check_inputs(peq, windows_t, window_valid, k, maxerr)
    C = peq.shape[0]
    m, W = windows_t.shape
    if C == 0 or W == 0:
        return torch.zeros(C, dtype=torch.int32, device=peq.device)
    if _on_cpu(peq, "approx_counts_myers"):
        return approx_counts_ref(peq, windows_t, window_valid, k, maxerr)

    from approx_counter_tpu_torch.kernels._build import myers_build

    peq32 = _as_int32_bits(peq).contiguous()
    out = torch.zeros(C, dtype=torch.int32, device=peq.device)
    fn = myers_build("bpm_myers", k).lib.bpm_myers
    for c0, n in word_launches(C, SLICED_CANDS):
        _launch(fn, (peq32[c0:c0 + n], windows_t, window_valid,
                     out[c0:c0 + n]), (n, m, W, k, maxerr))
        approx_counts_myers.launches += 1
    return out


approx_counts_myers.launches = 0


def approx_counts_packed(peq: torch.Tensor, windows_t: torch.Tensor,
                         window_valid: torch.Tensor, k: int,
                         maxerr: int = MAXERR, pack: int = 2,
                         algo: str = "myers") -> torch.Tensor:
    """int32 [C] approximate counts by a kernel that takes SWAR words,
    ``pack`` candidates per 32-bit word: ``csrc/bpm_packed.cu``
    (``algo="myers"``, pack 2 or 4) or ``csrc/nfa_packed.cu``
    (``algo="nfa"``, pack 1, 2, 4, 8 or 16) for CUDA tensors,
    ``approx_counts_packed_ref`` for CPU tensors.  k must be at most
    32 // pack.  Any C: past 65,535 groups of 32 // pack words (2,097,120
    candidates) the words are split over several launches
    (``word_launches``).
    ``approx_counts_packed.launches[algo]`` counts each kernel's launches.

    The counterpart of the JAX package's ``approx_counts_pallas_packed``;
    its ``ct``, ``wt``, ``eqsel`` and ``interpret`` do not carry over, for
    the reasons given in ``approx_counts_myers``.  C needs no padding: the
    words are padded here and the pad candidates sliced off.
    """
    _check_inputs(peq, windows_t, window_valid, k, maxerr)
    _check_packed(k, pack, algo)
    C = peq.shape[0]
    m, W = windows_t.shape
    if C == 0 or W == 0:
        return torch.zeros(C, dtype=torch.int32, device=peq.device)
    if _on_cpu(peq, "approx_counts_packed"):
        return approx_counts_packed_ref(peq, windows_t, window_valid, k,
                                        maxerr, pack, algo)

    from approx_counter_tpu_torch.kernels._build import (
        myers_build,
        nfa_packed_build,
    )

    words = _as_int32_bits(interleave_peq(peq, pack)).contiguous()
    out = torch.zeros(words.shape[0] * pack, dtype=torch.int32, device=peq.device)
    if algo == "myers":
        fn = myers_build("bpm_packed", k).lib.bpm_packed
    else:
        fn = nfa_packed_build(k, maxerr).lib.nfa_packed
    for w0, n in word_launches(words.shape[0], SLICED_CANDS // pack):
        _launch(fn, (words[w0:w0 + n], windows_t, window_valid,
                     out[pack * w0:pack * (w0 + n)]), (n, m, W, k, maxerr, pack))
        approx_counts_packed.launches[algo] += 1
    return out[:C]


approx_counts_packed.launches = {"myers": 0, "nfa": 0}
