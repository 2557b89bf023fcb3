"""The port must run where JAX is not installed.

A subprocess blocks ``jax`` and the JAX package (``sys.modules[name] =
None`` makes their import fail), imports every module of
``approx_counter_tpu_torch`` (the three of ``dist/``, ``searchscheme`` and
the bench among them), imports the names each sub-package's ``__init__`` re-exports,
holds a plain count to ``search_scheme_error_count``, runs one fused
pass (``Engine._pass_output``, ``unpack_pass_output``) and one resume
pass (``Engine.approx_stage``), imports the sharded step's pieces, and runs a
tiny ``run_pipeline`` (once more at ``-mr 2`` through the device window
pool) and ``run_pipeline_multihost`` on the CPU.
It guards against an import chain such as the JAX package's
``io/fastx.py`` -> ``core/__init__.py`` -> ``core/complexity.py`` ->
``jax.numpy``.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

SCRIPT = textwrap.dedent(r"""
    import importlib, os, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["approx_counter_tpu"] = None
    import torch
    torch.set_num_threads(1)
    import approx_counter_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    dist = {"approx_counter_tpu_torch.dist." + m
            for m in ("sampling", "mesh", "multihost")}
    assert dist <= set(names), sorted(dist - set(names))
    assert "approx_counter_tpu_torch.bench" in names, names
    subs = {"approx_counter_tpu_torch." + m for m in (
        "core", "count", "io", "kernels", "dist", "sample", "config",
        "searchscheme")}
    assert subs <= set(names), sorted(subs - set(names))
    from approx_counter_tpu_torch.core import (codes_to_seq, complexity_score,
                                               complexity_score_np, decode_kmer)
    from approx_counter_tpu_torch.core.codec import is_dna
    from approx_counter_tpu_torch.core.complexity import have_low_complexity
    from approx_counter_tpu_torch.core.ordering import (
        compare_count_keys, compare_count_np, sort_by_compare_count)
    from approx_counter_tpu_torch.count import (exact_count_select,
                                                exact_count_select_rows)
    from approx_counter_tpu_torch.count.exact import (exact_count_local_rows,
                                                      select_counted_rows)
    from approx_counter_tpu_torch.dist.mesh import (
        bucket_slots, exchange, gather, local_segment, merge_owned,
        next_sizes, owner_segment)
    from approx_counter_tpu_torch.count.approx import approx_count_rank
    from approx_counter_tpu_torch.dist import (approx_counts_sharded,
                                               gather_windows, initialize)
    from approx_counter_tpu_torch.io import print_counters, read_fastx
    from approx_counter_tpu_torch.kernels import (approx_counts, approx_counts_ref,
                                                  build_peq)
    from approx_counter_tpu_torch.sample import sample_windows
    from approx_counter_tpu_torch.config import resolve_params
    from approx_counter_tpu_torch.searchscheme import search_scheme_error_count
    import numpy as np
    wins = np.array([[0, 1, 2, 3, 4, 5, 0, 1]], np.uint8)
    codes = torch.tensor([0b00011011, 0b11111111])
    counts = approx_counts_ref(build_peq(codes, 4), torch.from_numpy(wins.T.copy()),
                               torch.ones(1, dtype=torch.bool), 4)
    assert counts.tolist() == [3, 0], counts
    assert search_scheme_error_count(list(wins), codes, 4) == {27: 3, 255: 0}
    from approx_counter_tpu_torch.dist.multihost import run_pipeline_multihost
    from approx_counter_tpu_torch.params import Params
    from approx_counter_tpu_torch.pipeline import (
        Engine, candidates_from_codes, pass_cap, run_pipeline,
        unpack_pass_output)
    # one fused pass: its fixed-shape body eagerly, packed and unpacked
    engine = Engine(Params(k=4, sl=7, limit=3), "cpu")
    wins_t = torch.from_numpy(np.tile(wins.T, (1, 4)).copy())
    mask = torch.ones(4, dtype=torch.bool)
    packed = engine._pass_output(pass_cap(3), wins_t, mask)
    out = unpack_pass_output(packed, pass_cap(3), 4)
    assert (int(out["exact"]["n_keep"]), int(out["exact"]["sel_lo"][0]),
            int(out["approx_count"][0])) == (1, 27, 12), out
    # the resume pass at the fixed cap of candidates_from_codes
    assert candidates_from_codes(np.array([27], np.uint64))[2] == 512
    got = engine.approx_stage(np.tile(wins, (4, 1)), 4,
                              np.array([27, 255, 27], np.uint64))
    assert [c.tolist() for c in got] == [[27, 27, 255], [12, 12, 0]], got
    engine.close()
    tmp = sys.argv[1]
    with open(os.path.join(tmp, "r.fasta"), "w") as f:
        for i in range(6):
            f.write(f">r{i}\n" + "ACGTTGCA" * 8 + "\n")
    prm = Params(input_file=os.path.join(tmp, "r.fasta"),
                 output=os.path.join(tmp, "o"), k=5, sl=20, sn=6, limit=4,
                 v=0, seed=1)
    assert run_pipeline(prm, device="cpu") == 0
    assert os.path.getsize(os.path.join(tmp, "o_0.start")) > 0
    # pipelined passes through the device window pool and the upload path
    prm.output, prm.nb_of_runs, prm.device_pool = (
        os.path.join(tmp, "pool"), 2, "on")
    assert run_pipeline(prm, device="cpu") == 0
    assert os.path.getsize(os.path.join(tmp, "pool_1.end")) > 0
    prm.nb_of_runs, prm.device_pool = 1, "auto"
    prm.output, prm.multihost = os.path.join(tmp, "mh"), True
    assert run_pipeline_multihost(prm, device="cpu") == 0
    assert os.path.getsize(os.path.join(tmp, "mh_0.start")) > 0
    leaked = [m for m in sys.modules
              if m.startswith(("jax.", "approx_counter_tpu."))]
    assert sys.modules["jax"] is None, "jax was imported"
    assert sys.modules["approx_counter_tpu"] is None, "JAX package imported"
    assert not leaked, leaked
    print("imported", len(names))
""")


def test_port_imports_and_runs_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
