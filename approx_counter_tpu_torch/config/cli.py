"""CLI with the reference's exact flag set and resolution precedence.

Flags mirror ``get_args`` (approx_counter.cpp:604-669); the
resolution order mirrors main(): code defaults (:700-715), then config file
(:721-737), then CLI overrides (:744-758).  ``skip_end`` is OR-merged (:758);
in a config file the *presence* of the ``se`` key makes it true (:733).

Framework extensions: ``--seed`` (deterministic sampling) and
``--compat-quirks`` (reproduce documented reference bugs); both are additive
and absent flags change nothing.
"""

from __future__ import annotations

import argparse
import sys

from approx_counter_tpu_torch.config.conf import parse_config
from approx_counter_tpu_torch.params import Params

_SENTINEL = object()


class _RefExitParser(argparse.ArgumentParser):
    """argparse exits 2 on a parse error; the reference's ``get_args``
    returns PARSE_ERROR and ``main`` turns that into exit code **1**
    (help/version stay 0) -- approx_counter.cpp:693-698.
    Porechop_ABI drives adaptFinder as a subprocess, so the code is
    consumer-visible.  Only the code changes; the usage/error text keeps
    argparse's format (COMPAT #18)."""

    def error(self, message):
        self.print_usage(sys.stderr)
        self.exit(1, f"{self.prog}: error: {message}\n")


def build_parser() -> argparse.ArgumentParser:
    p = _RefExitParser(
        prog="adaptFinder",
        description="Approximate k-mer counter on an NVIDIA GPU "
        "(capabilities of qbonenfant/approx_counter; PyTorch/CUDA port)",
    )
    p.add_argument("input_file", help="input FASTA/FASTQ file")
    p.add_argument("-lc", "--low_complexity", type=float, default=None,
                   help="low complexity filter threshold (for k=16), default 1.0")
    p.add_argument("-sn", "--sample_n", type=int, default=None,
                   help="sample n sequences from dataset, default 40000 sequences")
    p.add_argument("-sl", "--sample_length", type=int, default=None,
                   help="size of the sampled portion, default 100 bases")
    p.add_argument("-nt", "--nb_thread", type=int, default=None,
                   help="number of threads (compat; the GPU path ignores it)")
    p.add_argument("-k", "--kmer_size", type=int, default=None,
                   help="size of the kmers, default is 16")
    p.add_argument("-lim", "--limit", type=int, default=None,
                   help="limit the number of kmer used after initial counting, "
                        "default is 500")
    p.add_argument("-mr", "--multi_run", type=int, default=None,
                   help="number of times the count must be performed; each count "
                        "is exported separately")
    p.add_argument("-v", "--verbosity", type=int, default=None,
                   help="level of details printed out")
    p.add_argument("-e", "--exact_file", type=str, default=None,
                   help="path to export the exact k-mer count; default: no export")
    p.add_argument("-conf", "--config", type=str, default=None,
                   help="path to the config file")
    p.add_argument("-fk", "--forbidden_kmer", type=str, default=None,
                   help="file of 'forbidden' kmers excluded from the search pool, "
                        "one kmer per line")
    p.add_argument("-sk", "--solid_km", type=int, default=None,
                   help="use solid kmers (count >= threshold) instead of most "
                        "frequent")
    p.add_argument("-se", "--skip_end", action="store_true", default=False,
                   help="skip end adapter research (only search start)")
    p.add_argument("-o", "--out_file", type=str, default=None,
                   help="path to the output file, default is ./out.txt")
    # --- framework extensions ---
    p.add_argument("--seed", type=int, default=None,
                   help="deterministic sampling seed (extension; default: OS "
                        "entropy, like the reference)")
    p.add_argument("--compat-quirks", action="store_true", default=False,
                   help="reproduce documented reference bugs (see SURVEY.md §5)")
    p.add_argument("--stream", action="store_true", default=False,
                   help="stream the input in bounded memory with reservoir "
                        "sampling (extension; for files larger than RAM)")
    p.add_argument("--max-error", type=int, default=None, metavar="E",
                   help="edit-distance bound for approximate counting, "
                        "0 <= E <= 3 (extension; the reference hardcodes 2)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to "
                        "DIR/trace.json (extension)")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="multi-rank mode: one rank per process under "
                        "torchrun, the comma-separated input files dealt "
                        "round-robin to the ranks (extension)")
    p.add_argument("--from-exact", type=str, default=None,
                   help="resume: read candidate k-mers from a prior exact "
                        "export (kmer\\tcount lines) instead of re-counting "
                        "(extension)")
    p.add_argument("--device-pool", choices=("auto", "on", "off"),
                   default="auto",
                   help="device-resident window pool for multi-pass runs: "
                        "ship every eligible read's windows once, gather "
                        "each pass's batch on device from a small index "
                        "vector (extension; auto = when the pool bytes "
                        "undercut the per-pass planes; in-memory mode "
                        "only -- inert under --stream/--from-exact)")
    return p


def resolve_params(argv: list[str]) -> Params:
    args = build_parser().parse_args(argv)
    prm = Params(input_file=args.input_file)

    # Layer 2: config file (approx_counter.cpp:721-737).
    if args.config:
        prm.config_file = args.config
        cfg = parse_config(args.config)
        if "lc" in cfg:
            prm.param_lc = float(cfg["lc"])
        if "k" in cfg:
            prm.k = int(cfg["k"])
        if "v" in cfg:
            prm.v = int(cfg["v"])
        if "sn" in cfg:
            prm.sn = int(cfg["sn"])
        if "sl" in cfg:
            prm.sl = int(cfg["sl"])
        if "lim" in cfg:
            prm.limit = int(cfg["lim"])
        if "nt" in cfg:
            prm.nb_thread = int(cfg["nt"])
        if "sk" in cfg:
            prm.solid_km = int(cfg["sk"])
        prm.skip_end = "se" in cfg  # presence alone sets it (:733)
        if "fk" in cfg:
            prm.forbid_kmer = cfg["fk"]
        if "e" in cfg:
            prm.exact_out = cfg["e"]
        if "mr" in cfg:
            prm.nb_of_runs = int(cfg["mr"])

    # Layer 3: CLI overrides when flags are present (:744-758).
    if args.limit is not None:
        prm.limit = args.limit
    if args.low_complexity is not None:
        prm.param_lc = args.low_complexity
    if args.kmer_size is not None:
        prm.k = args.kmer_size
    if args.verbosity is not None:
        prm.v = args.verbosity
    if args.sample_length is not None:
        prm.sl = args.sample_length
    if args.sample_n is not None:
        prm.sn = args.sample_n
    if args.nb_thread is not None:
        prm.nb_thread = args.nb_thread
    if args.out_file is not None:
        prm.output = args.out_file
    if args.exact_file is not None:
        prm.exact_out = args.exact_file
    if args.forbidden_kmer is not None:
        prm.forbid_kmer = args.forbidden_kmer
    if args.solid_km is not None:
        prm.solid_km = args.solid_km
    if args.multi_run is not None:
        prm.nb_of_runs = args.multi_run
    prm.skip_end = prm.skip_end or args.skip_end  # OR-merge (:758)

    prm.seed = args.seed
    prm.compat_quirks = args.compat_quirks
    prm.stream = args.stream
    prm.multihost = args.multihost
    if args.profile is not None:
        prm.profile_dir = args.profile
    if args.max_error is not None:
        if not 0 <= args.max_error <= 3:
            build_parser().error("--max-error must be in [0, 3]")
        prm.max_error = args.max_error
    if args.from_exact is not None:
        prm.from_exact = args.from_exact
    prm.device_pool = args.device_pool
    return prm
