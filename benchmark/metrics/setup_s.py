"""Seconds from the process's start to the window's: imports, the CUDA
context, the FASTA file written from the seed, the kernels built or
loaded, and one warm-up job."""


def read(run):
    return run.setup_s
