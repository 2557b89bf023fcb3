"""Approximate counts of candidate k-mers against sampled windows.

Port of ``approx_counter_tpu/kernels/bpm.py``.  For every candidate k-mer c
the count is the sum over valid windows w of

    max(0, maxerr + 1 - d_min(c, w))

where d_min is the least edit distance between c and any substring of w
(the reference's per-error-level counting, approx_counter.cpp:531-601).
Window symbols >= 4 (N, pad) match no candidate base.

Two implementations of that function live here:

  * ``approx_counts_ref`` -- the plain torch version: Myers' 1999
    bit-vector DP, one 32-bit word per (candidate, window), a twin of the
    JAX package's ``approx_counts_jnp``.  The CPU path and the oracle for
    the kernel.
  * the CUDA kernel ``csrc/nfa_sliced.cu`` -- the candidate-bit-sliced
    level NFA that replaces the Pallas kernel ``_nfa_kernel_sliced``.

``approx_counts`` dispatches on the tensors' device: the plain version for
CPU tensors, the kernel for CUDA tensors, and nothing else.

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
    """Candidate bit-planes for the sliced NFA: [C, 4] peq -> (P0, P1),
    each int64 [C // 32, k] holding uint32 values.

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


def approx_counts_ref(peq: torch.Tensor, windows_t: torch.Tensor,
                      window_valid: torch.Tensor, k: int,
                      maxerr: int = MAXERR) -> torch.Tensor:
    """Plain torch version: Myers' bit-vector DP over the text rows.

    peq:          int64 [C, 4]
    windows_t:    uint8 [m, W] (transposed windows)
    window_valid: bool [W]
    returns       int32 [C]
    """
    C = peq.shape[0]
    m, W = windows_t.shape
    dev = peq.device
    # one all-zero column per symbol >= 4: N and pad match nothing
    peq6 = torch.cat([peq, torch.zeros((C, 2), dtype=torch.int64, device=dev)], 1)
    VP = torch.full((C, W), _M32, dtype=torch.int64, device=dev)
    VN = torch.zeros((C, W), dtype=torch.int64, device=dev)
    score = torch.full((C, W), k, dtype=torch.int64, device=dev)
    minsc = score.clone()
    for j in range(m):
        Eq = peq6.index_select(1, windows_t[j].to(torch.int64))
        Xv = Eq | VN
        Xh = ((((Eq & VP) + VP) & _M32) ^ VP) | Eq
        Ph = VN | (~(Xh | VP) & _M32)
        Mh = VP & Xh
        score += ((Ph >> (k - 1)) & 1) - ((Mh >> (k - 1)) & 1)
        Ph = (Ph << 1) & _M32
        Mh = (Mh << 1) & _M32
        VP = Mh | (~(Xv | Ph) & _M32)
        VN = Ph & Xv
        torch.minimum(minsc, score, out=minsc)
    contrib = (maxerr + 1 - minsc).clamp_(min=0) * window_valid[None, :]
    return contrib.sum(dim=1).to(torch.int32)


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


def approx_counts(peq: torch.Tensor, windows_t: torch.Tensor,
                  window_valid: torch.Tensor, k: int,
                  maxerr: int = MAXERR) -> torch.Tensor:
    """int32 [C] approximate counts: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``approx_counts.launches`` counts the
    kernel launches."""
    _check_inputs(peq, windows_t, window_valid, k, maxerr)
    C = peq.shape[0]
    m, W = windows_t.shape
    if C == 0 or W == 0:
        return torch.zeros(C, dtype=torch.int32, device=peq.device)
    if peq.device.type == "cpu":
        return approx_counts_ref(peq, windows_t, window_valid, k, maxerr)
    if peq.device.type != "cuda":
        raise ValueError(f"approx_counts runs on cpu or cuda, not {peq.device}")

    from approx_counter_tpu_torch.kernels._build import nfa_sliced_build

    c_pad = -(-C // 32) * 32
    if c_pad != C:  # zero rows decode as poly-A: garbage counts, sliced off
        peq = torch.cat(
            [peq, torch.zeros((c_pad - C, 4), dtype=peq.dtype, device=peq.device)]
        )
    p0, p1 = (_as_int32_bits(p).contiguous() for p in build_sliced_planes(peq, k))
    out = torch.zeros(c_pad, dtype=torch.int32, device=peq.device)
    lib = nfa_sliced_build(k, maxerr).lib
    with torch.cuda.device(peq.device):
        rc = lib.nfa_sliced(
            p0.data_ptr(), p1.data_ptr(), windows_t.data_ptr(),
            window_valid.data_ptr(), out.data_ptr(), c_pad // 32, m, W,
            torch.cuda.current_stream(peq.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nfa_sliced kernel launch failed: CUDA error {rc}")
    approx_counts.launches += 1
    return out[:C]


approx_counts.launches = 0
