"""The exact stage's two elementwise steps, each one CUDA kernel, and the
re-rank's dimer sums.

``count/exact.py`` counts k-mers in fixed shapes (``exact_count_local_rows``
then ``select_counted_rows``).  Two of its steps are elementwise over every
position or slot, and each is a hand-written kernel here:

  * ``position_keys`` -> ``csrc/position_keys.cu``: step 1, every sliding
    position's sort-ready int64 key (its k-mer code, or code 0 when the
    position holds an N or a pad or its window is not real, with the sign
    bit flipped) and the batch's valid and N-containing position totals.
  * ``slot_keys`` -> ``csrc/slot_keys.cu``: step 3 on (code, count) slots,
    the DUST dimer sum, the filters, the masked count and step 4's ranking
    keys, and the number of slots kept and of slots counted.

``slot_dimers`` -> ``csrc/slot_dimers.cu`` is the dimer sum alone, which
``count/approx.py``'s re-rank and ``dist/mesh.py``'s merge give
``compare_count_order``.  The two .cu files share ``csrc/dimer_sum.cuh``.

None replaces a TPU kernel: the JAX package left these steps to XLA,
which fuses them; torch launches each op on its own, about 370 launches a
default pass at k = 16.  Each wrapper dispatches on the tensors' device:
the plain version (``position_keys_ref``, ``slot_keys_ref``,
``core/complexity.py:dimer_sum``: the torch ops that the CPU tests hold to
the JAX package) for CPU tensors, the kernel for CUDA tensors, and nothing
else.  Outputs are equal bit for bit.  Each wrapper's ``launches`` counts
its kernel's launches.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.core.complexity import dimer_sum
from approx_counter_tpu_torch.core.ordering import _SIGN
from approx_counter_tpu_torch.kernels.bpm import _launch, _on_cpu

#: Above any count of a batch: ``select_counted_rows``'s first top-k key
#: ranks ``COUNT_CEIL - count``, non-negative for a count summed over
#: ranks too.
COUNT_CEIL = 1 << 40
#: Forbidden codes one broadcast compare of ``slot_keys_ref`` takes: its
#: bool intermediate is P x this.
FORBID_CHUNK = 16
_I32_MAX = (1 << 31) - 1


def positions(windows_t: torch.Tensor, row_mask: torch.Tensor, k: int):
    """Step 1's plain packing sweep on a window batch (uint8 ``[m, n]``,
    text-major; bool row mask ``[n]``): every position's int64 code and
    validity, flat, and the number of N-containing k-mers in real windows
    as an int64 scalar tensor."""
    if not 2 <= k <= 32:
        raise ValueError(f"exact_count_select takes 2 <= k <= 32, got {k}")
    m, n = windows_t.shape
    p = m - k + 1  # sliding positions per window (ref :496)

    # At k = 32 the last shift moves the first base into bits 62-63: the
    # int64 shift wraps like the uint64 one, so the code holds the uint64
    # bits (negative as int64 when the first base is G or T).
    code = torch.zeros((p, n), dtype=torch.int64, device=windows_t.device)
    has_n = torch.zeros((p, n), dtype=torch.bool, device=windows_t.device)
    has_pad = torch.zeros_like(has_n)
    for j in range(k):
        sym = windows_t[j:j + p]
        has_n |= sym == 4
        has_pad |= sym >= 5
        code = (code << 2) | (sym & 3)
    row_valid = row_mask[None, :]
    # N-containing k-mers in real windows (ref had_n tally :513-517);
    # positions touching padding are not real sliding positions.
    had_n = (has_n & ~has_pad & row_valid).sum()
    valid = ~(has_n | has_pad) & row_valid
    return code.reshape(-1), valid.reshape(-1), had_n


def position_keys_ref(windows_t: torch.Tensor, row_mask: torch.Tensor,
                      k: int):
    """Plain version of ``position_keys``: ``positions``, then the keys."""
    code, valid, had_n = positions(windows_t, row_mask, k)
    return torch.where(valid, code, 0) ^ _SIGN, valid.sum(), had_n


def position_keys(windows_t: torch.Tensor, row_mask: torch.Tensor, k: int):
    """Step 1 on a window batch (uint8 ``[m, n]``, text-major; bool row
    mask ``[n]``): ``(keys, n_valid, had_n)``, the int64 ``[(m - k + 1) *
    n]`` keys (position i of window w at ``i * n + w``: its code XOR the
    sign bit when it holds no N or pad and its window is real, the sign
    bit alone otherwise), the number of valid positions and the number of
    N-containing k-mers in real windows, both 0-d int64.
    ``csrc/position_keys.cu`` for CUDA tensors, ``position_keys_ref`` for
    CPU tensors.  No host sync."""
    if not 2 <= k <= 32:
        raise ValueError(f"exact_count_select takes 2 <= k <= 32, got {k}")
    if windows_t.dtype != torch.uint8 or windows_t.dim() != 2:
        raise ValueError(f"windows_t must be uint8 [m, n], got "
                         f"{windows_t.dtype} {tuple(windows_t.shape)}")
    m, n = windows_t.shape
    if row_mask.dtype != torch.bool or tuple(row_mask.shape) != (n,):
        raise ValueError(f"row_mask must be bool [{n}], got {row_mask.dtype} "
                         f"{tuple(row_mask.shape)}")
    if row_mask.device != windows_t.device:
        raise ValueError("windows_t and row_mask must share a device")
    if _on_cpu(windows_t, "position_keys"):
        return position_keys_ref(windows_t, row_mask, k)

    from approx_counter_tpu_torch.kernels._build import kernel_build

    dev = windows_t.device
    keys = torch.empty((m - k + 1) * n, dtype=torch.int64, device=dev)
    if not keys.numel():
        return keys, *torch.zeros(2, dtype=torch.int64, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)  # zeroed in C
    _launch(kernel_build("position_keys").lib.position_keys,
            (windows_t.contiguous(), row_mask.contiguous(), keys, totals),
            (m, n, k))
    position_keys.launches += 1
    return keys, totals[0], totals[1]


position_keys.launches = 0


def slot_keys_ref(codes: torch.Tensor, counts: torch.Tensor, k: int,
                  lc_sum_thr: int, forbidden: torch.Tensor, solid_km: int,
                  key_bits: int | None) -> dict:
    """Plain version of ``slot_keys``: ``dimer_sum``, the filters, the
    masked count and the keys in torch ops."""
    dimer = dimer_sum(codes, k)
    keep = (counts > 0) & (dimer < lc_sum_thr)
    for f0 in range(0, forbidden.numel(), FORBID_CHUNK):
        chunk = forbidden[f0:f0 + FORBID_CHUNK]
        keep &= ~(codes[:, None] == chunk[None, :]).any(dim=1)
    count = torch.where(keep, counts, 0)
    if solid_km > 0:
        keep &= count >= solid_km
        count = torch.where(keep, count, 0)
    out = dict(count=count, n_pass=keep.sum(), n_unique=(counts > 0).sum())
    if key_bits is None:
        return dict(out, dimer=dimer, keep=keep)
    return dict(out, key1=((COUNT_CEIL - count) << key_bits) | dimer,
                ncode=~(codes ^ _SIGN))


def slot_keys(codes: torch.Tensor, counts: torch.Tensor, k: int,
              lc_sum_thr: int, forbidden: torch.Tensor, solid_km: int,
              key_bits: int | None) -> dict:
    """Steps 3-4's elementwise part on (code, count) slots (int64 ``[P]``
    each; a count of 0 marks an empty slot): a slot is kept when its count
    is positive, its dimer sum under ``lc_sum_thr``, its code not among the
    int64 ``forbidden`` (any F, 0 too) and, when ``solid_km > 0``, its
    count at least ``solid_km``.  Returns ``count`` (int64 ``[P]``, 0 where
    not kept), ``n_pass`` (slots kept) and ``n_unique`` (slots with a
    positive count) as 0-d int64, and with ``key_bits`` the two keys of
    ``count/exact.py:_topk_rank``, ``key1 = ((COUNT_CEIL - count) <<
    key_bits) | dimer`` and ``ncode = ~(code ^ sign)`` (int64 ``[P]``),
    without it ``dimer`` (int32 ``[P]``) and ``keep`` (bool ``[P]``).
    ``csrc/slot_keys.cu`` for CUDA tensors, ``slot_keys_ref`` for CPU
    tensors.  No host sync."""
    if not 2 <= k <= 32:
        raise ValueError(f"slot_keys takes 2 <= k <= 32, got {k}")
    if key_bits is not None and not 0 <= key_bits <= 22:
        raise ValueError(f"key_bits={key_bits}: need 0 <= key_bits <= 22")
    for name, t in (("codes", codes), ("counts", counts),
                    ("forbidden", forbidden)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be int64 [n], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if counts.shape != codes.shape:
        raise ValueError(f"counts {tuple(counts.shape)} must match codes "
                         f"{tuple(codes.shape)}")
    if not codes.device == counts.device == forbidden.device:
        raise ValueError("codes, counts and forbidden must share a device")
    if _on_cpu(codes, "slot_keys"):
        return slot_keys_ref(codes, counts, k, lc_sum_thr, forbidden,
                             solid_km, key_bits)

    from approx_counter_tpu_torch.kernels._build import kernel_build

    P = codes.shape[0]
    dev = codes.device
    if key_bits is None:
        kinds = dict(count=torch.int64, dimer=torch.int32, keep=torch.bool)
    else:
        kinds = dict(count=torch.int64, key1=torch.int64, ncode=torch.int64)
    out = {name: torch.empty(P, dtype=t, device=dev)
           for name, t in kinds.items()}
    if not P:
        zero = codes.new_zeros(())
        return dict(out, n_pass=zero, n_unique=zero.clone())
    totals = torch.empty(2, dtype=torch.int64, device=dev)  # zeroed in C
    # a threshold past every dimer sum (at most 930) or under every one
    # keeps its meaning when clamped to int32; so does solid_km to 2^62
    _launch(kernel_build("slot_keys").lib.slot_keys,
            (codes.contiguous(), counts.contiguous(), forbidden.contiguous(),
             *(out.get(name) for name in ("count", "key1", "ncode", "dimer",
                                          "keep")), totals),
            (P, forbidden.numel(), k,
             max(-_I32_MAX, min(lc_sum_thr, _I32_MAX)),
             min(solid_km, 1 << 62), key_bits or 0))
    slot_keys.launches += 1
    return dict(out, n_pass=totals[0], n_unique=totals[1])


slot_keys.launches = 0


def slot_dimers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """``core/complexity.py:dimer_sum`` of int64 ``codes`` (any shape):
    int32 of the codes' shape.  ``csrc/slot_dimers.cu`` for CUDA tensors,
    ``dimer_sum`` itself for CPU tensors.  No host sync."""
    if not 2 <= k <= 32:
        raise ValueError(f"dimer_sum takes 2 <= k <= 32, got {k}")
    if codes.dtype != torch.int64:
        raise ValueError(f"codes must be int64, got {codes.dtype}")
    if _on_cpu(codes, "slot_dimers"):
        return dimer_sum(codes, k)

    from approx_counter_tpu_torch.kernels._build import kernel_build

    flat = codes.reshape(-1).contiguous()
    dimer = torch.empty(flat.shape[0], dtype=torch.int32, device=codes.device)
    if flat.shape[0]:
        _launch(kernel_build("slot_dimers").lib.slot_dimers, (flat, dimer),
                (flat.shape[0], k))
        slot_dimers.launches += 1
    return dimer.view(codes.shape)


slot_dimers.launches = 0
