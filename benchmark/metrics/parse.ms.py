"""The parse's ms, median over the jobs: the program's log from "Parsing
FASTA file" to "Number of sequences found" (``io/fastx.py`` ->
``csrc/fastx_parser.cpp``)."""

from benchmark.check import parse_ms
from benchmark.trace import median


def read(run):
    return median(parse_ms(j.log) for j in run.jobs)
