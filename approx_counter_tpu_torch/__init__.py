"""PyTorch + CUDA port of the approximate k-mer counting engine.

The JAX package ``approx_counter_tpu`` beside this one is the reference: it
keeps the same module names, so each module here has a counterpart there.
This package imports ``torch`` and never ``jax``, so it runs on a host that
has PyTorch with CUDA and no JAX.

Layout:
  * ``core``    -- 2-bit codec, DUST complexity, CompareCount order
  * ``io``      -- FASTA/FASTQ reader, exporters, timestamped logger
  * ``config``  -- CLI and config-file layering (``params.Params``)
  * ``sample``  -- read-end window sampler (numpy, same rng draws)
  * ``count``   -- exact counting and top-N selection, approximate re-rank
  * ``kernels`` -- the candidate-bit-sliced level NFA: a CUDA kernel
                   (``csrc/nfa_sliced.cu``) and its plain torch version
  * ``interop`` -- conversions between the JAX package's numpy arrays and
                   this package's tensors (tests)
"""

__version__ = "0.1.0"

from approx_counter_tpu_torch.params import Params  # noqa: F401
