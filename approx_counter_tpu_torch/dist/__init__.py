"""Counting across ranks over ``torch.distributed``: the port of the JAX
package's ``dist/`` (distributed bottom-k sampling, window-sharded counts
with an all-reduce, and the ``--multihost`` orchestrator).

The JAX package's ``data_mesh`` and ``shard_windows`` place arrays on a
device mesh; here ``initialize`` joins the process group and
``gather_windows`` all-gathers the ranks' window batches.
``make_full_step`` is a sharded engine's pass (``Engine(sharded=True)``,
the fixed-cap segments of ``dist/mesh.py``): each rank counts its own
windows and each code is selected on its owner rank."""

from approx_counter_tpu_torch.dist.mesh import (  # noqa: F401
    approx_counts_sharded,
    gather_windows,
    initialize,
)
