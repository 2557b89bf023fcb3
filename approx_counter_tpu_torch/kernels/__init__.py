# The JAX package's approx_counts_jnp is approx_counts_ref here, and its
# approx_counts_pallas (unpacked Myers) is approx_counts_myers.  Importing
# this package builds no kernel: each wrapper builds its kernel at its first
# call on a CUDA tensor.
from approx_counter_tpu_torch.kernels.bpm import (  # noqa: F401
    approx_counts,
    approx_counts_myers,
    approx_counts_ref,
    build_peq,
)
