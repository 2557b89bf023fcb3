"""Counting across ranks over ``torch.distributed``: the port of the JAX
package's ``dist/`` (distributed bottom-k sampling, window-sharded counts
with an all-reduce, and the ``--multihost`` orchestrator)."""
