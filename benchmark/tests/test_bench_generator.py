"""The traffic generator: the same bytes for a seed, the mix's shape."""

import hashlib
import json

import numpy as np
import pytest

from benchmark import generate
from benchmark.harness import BENCH
from benchmark.reference import adaptfinder as ref
from benchmark.tests.conftest import TINY_TRAFFIC

MIX = json.loads((BENCH / "traffic" / "nanopore_synthetic.json").read_text())
TINY = dict(MIX, **TINY_TRAFFIC)
SEED = 2**31 + 99


def digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_bytes_stable_for_a_seed(tmp_path):
    a, b, c = (tmp_path / n for n in "abc")
    generate.write_fasta(str(a), TINY, SEED)
    generate.write_fasta(str(b), TINY, SEED)
    generate.write_fasta(str(c), TINY, SEED + 1)
    assert digest(a) == digest(b) != digest(c)
    # pinned: a change to the generator or to numpy's streams shows here
    assert digest(a) == ("67e5d469f0087266861c3b9cc0450beb"
                         "3290283388394566d1422882030cc5a2")


@pytest.mark.parametrize("seed", [0, SEED])
def test_mix_shape(tmp_path, seed):
    path = tmp_path / "r.fa"
    lengths = generate.write_fasta(str(path), TINY, seed)
    assert len(lengths) == TINY["reads"]
    assert lengths.min() >= TINY["length_min"]
    assert lengths.max() <= TINY["length_max"]
    lines = path.read_text().splitlines()
    assert lines[0::2] == [f">read{i}" for i in range(TINY["reads"])]
    seqs = lines[1::2]
    assert [len(s) for s in seqs] == lengths.tolist()
    assert set("".join(seqs)) <= set("ACGTN")
    buf, offsets = ref.read_fasta(str(path))
    assert np.diff(offsets).tolist() == lengths.tolist()
    n_share = "".join(seqs).count("N") / lengths.sum()
    assert 0.5 * TINY["n_rate"] < n_share < 2 * TINY["n_rate"]


def test_adapters_planted(tmp_path):
    """Unedited adapters open and close about a third of the reads (90%
    carry one, a third of those with no edit)."""
    mix = dict(TINY, reads=3000, n_rate=0.0)
    path = tmp_path / "r.fa"
    generate.write_fasta(str(path), mix, SEED)
    seqs = path.read_text().splitlines()[1::2]
    for ad in mix["adapters"]:
        a = ad["sequence"]
        hit = sum(s.startswith(a) if ad["at"] == "start" else s.endswith(a)
                  for s in seqs) / len(seqs)
        assert 0.25 < hit < 0.4, (ad["at"], hit)


def test_edits_follow_the_rules():
    """Each adapter copy is within ``max_edits`` edits of the adapter."""
    rng = np.random.default_rng(SEED)
    arr, length = generate._mutated(rng, b"ACGTACGTAC", 500, 2)
    assert set(length.tolist()) <= set(range(8, 13))
    for row, n in zip(arr, length):
        got = "".join("ACGT"[b] for b in row[:n])
        assert edit_distance(got, "ACGTACGTAC") <= 2


def edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]
