"""The port's ``-h`` against the JAX package's, option by option.

Every option's help text equals the JAX parser's, but for the description
and the three options whose text names the backend: ``-nt`` (the threads
the TPU path or the GPU path ignores), ``--profile`` (``jax.profiler`` or
``torch.profiler``) and ``--multihost`` (``jax.distributed`` or
``torchrun``).  ``--device-pool`` is held like any other option: the port
builds the pool as the JAX package does.
"""

import pytest

pytest.importorskip("torch")

from approx_counter_tpu.config.cli import build_parser as jax_parser  # noqa: E402
from approx_counter_tpu_torch.config.cli import build_parser  # noqa: E402

#: options whose help names the backend, so the two texts differ
BACKEND = {"-nt", "--profile", "--multihost"}


def _helps(parser):
    return {a.option_strings[0] if a.option_strings else a.dest: a.help
            for a in parser._actions}


JAX_HELPS = _helps(jax_parser())


def test_the_parsers_have_the_same_options():
    assert set(_helps(build_parser())) == set(JAX_HELPS)


@pytest.mark.parametrize("option", sorted(JAX_HELPS))
def test_option_help_equals_jax(option):
    got = _helps(build_parser())[option]
    if option in BACKEND:
        assert got != JAX_HELPS[option]
        assert "jax" not in got.lower() and "tpu" not in got.lower()
    else:
        assert got == JAX_HELPS[option]


def test_description_names_the_gpu_port():
    assert jax_parser().description != build_parser().description
    assert "GPU" in build_parser().description
