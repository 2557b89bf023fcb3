"""The compare-exchange stage network of the bitonic-stage probe.

Port of the Pallas kernel ``kernel`` in ``make_probe``
(``native/sort_stage_probe5.py:48``).  On int32 ``[rows, 128]``, a stage
splits the rows into groups of 16 and, lane by lane, puts the (signed)
minimum of rows i and i + 8 of each group in row i and the maximum in row
i + 8, for i in 0-7.  ``transpose_every=0`` runs ``stages`` stages;
``transpose_every=t`` runs ``stages // t`` levels, each t stages followed by
a transpose of every 128 x 128 tile, and drops the remainder as the probe
does (210 stages at t=20 run 200).

``stage_network`` launches ``csrc/sort_stage.cu`` for a CUDA tensor and
takes the plain version ``stage_network_ref`` for a CPU tensor, and nothing
else.
"""

from __future__ import annotations

import torch

from approx_counter_tpu_torch.kernels.bpm import _launch, _on_cpu

LANES = 128  # row width and tile side
GROUP = 16   # rows of a compare-exchange group


def stages_run(stages: int, transpose_every: int) -> int:
    """The stages the network runs: ``stages``, or whole levels of
    ``transpose_every`` stages."""
    if transpose_every:
        return stages // transpose_every * transpose_every
    return stages


def _check(x: torch.Tensor, stages: int, transpose_every: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"x must be int32 [rows, {LANES}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if stages < 0 or transpose_every < 0:
        raise ValueError(f"stages={stages}, transpose_every={transpose_every}: "
                         f"need both >= 0")
    rows = x.shape[0]
    if rows % GROUP or (transpose_every and rows % LANES):
        raise ValueError(f"rows={rows}: need rows % {GROUP} == 0, and rows % "
                         f"{LANES} == 0 when transposing")


def stage_network_ref(x: torch.Tensor, stages: int,
                      transpose_every: int = 0) -> torch.Tensor:
    """Plain torch version: every stage run one by one, as the probe runs
    them, with ``torch.minimum``/``torch.maximum`` on a ``[G, 2, 8, 128]``
    view and the transpose on ``[T, 128, 128]``.  Returns a new tensor."""
    _check(x, stages, transpose_every)
    rows = x.shape[0]

    def stage(x):
        y = x.reshape(rows // GROUP, 2, GROUP // 2, LANES)
        lo = torch.minimum(y[:, 0], y[:, 1])
        hi = torch.maximum(y[:, 0], y[:, 1])
        return torch.stack([lo, hi], dim=1).reshape(rows, LANES)

    x = x.clone()
    if transpose_every:
        for _ in range(stages // transpose_every):
            for _ in range(transpose_every):
                x = stage(x)
            x = x.reshape(rows // LANES, LANES, LANES).transpose(1, 2)
            x = x.contiguous().view(rows, LANES)
    else:
        for _ in range(stages):
            x = stage(x)
    return x


def stage_network(x: torch.Tensor, stages: int,
                  transpose_every: int = 0) -> torch.Tensor:
    """int32 ``[rows, 128]`` after the stage network: ``csrc/sort_stage.cu``
    for a CUDA tensor, ``stage_network_ref`` for a CPU tensor.
    ``stage_network.launches`` counts the kernel launches."""
    _check(x, stages, transpose_every)
    if _on_cpu(x, "stage_network"):
        return stage_network_ref(x, stages, transpose_every)

    from approx_counter_tpu_torch.kernels._build import kernel_build

    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    _launch(kernel_build("sort_stage").lib.sort_stage, (x, out),
            (x.shape[0], stages, transpose_every))
    stage_network.launches += 1
    return out


stage_network.launches = 0
