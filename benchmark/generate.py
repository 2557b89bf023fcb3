"""The benchmark's one traffic generator: a seeded synthetic FASTA file.

A traffic mix is a JSON file under ``traffic/`` whose keys this module
reads:

- ``reads``: how many records; ``length_min``, ``length_max``: each read's
  length, uniform between them (both included);
- ``n_rate``: about this share of bases is N (positions drawn with
  replacement);
- ``adapters``: a list of ``{"at": "start" | "end", "sequence", "share",
  "max_edits"}``: the sequence overwrites the first (or last) bases of that
  share of reads, after 0 to ``max_edits`` random edits (substitution,
  insertion or deletion at a uniform position, one after another), so a
  read keeps its length.

- ``reads_per_file`` (optional): the reads are written as chunk files of
  that many reads each, in read order (``write_chunks``), as a sequencer
  writes a run's basecalled reads, instead of one file.

Every other key (``why``, ``assumed``, ``reduced``) documents the mix.  The
bytes depend only on the parameters and the seed.  Each record is one
``>read<i>`` header line and one sequence line.
"""

from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
_CODE[_ACGT] = np.arange(4)


def _mutated(rng, adapter: bytes, count: int, max_edits: int):
    """``count`` copies of ``adapter`` after 0 to ``max_edits`` random
    edits each: (bases ``[count, len + max_edits]`` as codes 0-3, lengths).
    """
    width = len(adapter) + max_edits
    arr = np.zeros((count, width), np.uint8)
    arr[:, :len(adapter)] = _CODE[np.frombuffer(adapter, np.uint8)]
    length = np.full(count, len(adapter), np.int64)
    n_edits = rng.integers(0, max_edits + 1, count)
    ops = rng.integers(0, 3, (count, max_edits))
    where = rng.random((count, max_edits))
    base = rng.integers(0, 4, (count, max_edits), dtype=np.uint8)
    j = np.arange(width)[None, :]
    for e in range(max_edits):
        on = e < n_edits
        sub = (on & (ops[:, e] == 0))[:, None]
        ins = (on & (ops[:, e] == 1))[:, None]
        dele = (on & (ops[:, e] == 2))[:, None]
        p = (where[:, e] * length).astype(np.int64)[:, None]
        src = np.where(ins, j - (j > p), np.where(dele, j + (j >= p), j))
        arr = np.take_along_axis(arr, np.clip(src, 0, width - 1), 1)
        arr = np.where((sub | ins) & (j == p), base[:, e:e + 1], arr)
        length += ins[:, 0].astype(np.int64) - dele[:, 0].astype(np.int64)
    return arr, length


def reads(params: dict, seed: int):
    """The mix's reads as ASCII bases: ``(buf, offsets)`` with read i at
    ``buf[offsets[i]:offsets[i + 1]]``."""
    rng = np.random.default_rng(seed)
    n = int(params["reads"])
    lens = rng.integers(int(params["length_min"]),
                        int(params["length_max"]) + 1, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    buf = _ACGT[rng.integers(0, 4, int(offs[-1]), dtype=np.uint8)]
    n_ns = rng.binomial(int(offs[-1]), float(params["n_rate"]))
    buf[rng.integers(0, int(offs[-1]), n_ns)] = ord("N")
    for ad in params["adapters"]:
        ids = np.flatnonzero(rng.random(n) < float(ad["share"]))
        arr, length = _mutated(rng, ad["sequence"].encode("ascii"), len(ids),
                               int(ad["max_edits"]))
        if (length > lens[ids]).any():
            raise ValueError("an adapter is longer than its read")
        j = np.arange(arr.shape[1])[None, :]
        first = (offs[ids] if ad["at"] == "start"
                 else offs[ids + 1] - length)[:, None]
        inside = j < length[:, None]
        buf[(first + j)[inside]] = _ACGT[arr[inside]]
    return buf, offs


def fasta_bytes(params: dict, seed: int):
    """The mix's FASTA file as bytes (uint8), the read lengths, and the
    byte offset at which each record starts."""
    buf, offs = reads(params, seed)
    n = len(offs) - 1
    headers = [f">read{i}\n" for i in range(n)]
    # the bytes around the sequences, in order: header 0, then a newline
    # and the next header, ..., and the last newline
    other = np.frombuffer(("\n".join(headers) + "\n").encode("ascii"),
                          np.uint8)
    head_len = np.fromiter(map(len, headers), np.int64, n)
    seq_at = np.cumsum(head_len) + np.arange(n) + offs[:-1]
    is_seq = np.zeros(len(other) + len(buf) + 1, np.int8)
    np.add.at(is_seq, seq_at, 1)
    np.add.at(is_seq, seq_at + np.diff(offs), -1)
    is_seq = np.cumsum(is_seq[:-1], dtype=np.int8).view(bool)
    out = np.empty(len(is_seq), np.uint8)
    out[is_seq] = buf
    out[~is_seq] = other
    return out, np.diff(offs), seq_at - head_len


def write_fasta(path: str, params: dict, seed: int) -> np.ndarray:
    """Write the mix's FASTA file to ``path``; returns the read lengths."""
    out, lengths, _ = fasta_bytes(params, seed)
    out.tofile(path)
    return lengths


def write_chunks(prefix: str, params: dict, seed: int):
    """Write the mix's FASTA file as chunk files of ``reads_per_file``
    reads each, in read order, as a sequencer writes a run's reads:
    ``<prefix>_<j>.fa``, whose concatenation is ``write_fasta``'s file.
    Returns the paths and the read lengths."""
    out, lengths, starts = fasta_bytes(params, seed)
    per = int(params["reads_per_file"])
    cuts = np.append(starts[::per], len(out))
    paths = []
    for j in range(len(cuts) - 1):
        paths.append(f"{prefix}_{j}.fa")
        out[cuts[j]:cuts[j + 1]].tofile(paths[-1])
    return paths, lengths
