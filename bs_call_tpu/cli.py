"""bs_call-compatible command line interface.

Flag set mirrors bs_call_options.h:6-38; engine-specific flags are added
under their long names only.
"""

from __future__ import annotations

import argparse
import sys

from bs_call_tpu import constants as C
from bs_call_tpu.config import CallerConfig


def _pair(s: str):
    parts = s.split(",")
    if len(parts) == 1:
        v = int(parts[0])
        return (v, v)
    return (int(parts[0]), int(parts[1]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bs_call",
        description="Bisulfite variant + methylation caller with a GPU "
        "device tier "
        "(bs_call v%s capability parity)" % C.VERSION,
    )
    p.add_argument("input_file", nargs="?", help="SAM/BAM input (sorted)")
    # Operations
    p.add_argument("-1", "--haploid", action="store_true")
    p.add_argument("-d", "--keep-duplicates", action="store_true")
    p.add_argument("--ignore-duplicates", action="store_true")
    p.add_argument("-k", "--keep-unmatched", action="store_true")
    p.add_argument("-R", "--right-trim", type=_pair, default=(0, 0))
    p.add_argument("-L", "--left-trim", type=_pair, default=(0, 0))
    p.add_argument("-B", "--blank-trim", action="store_true")
    p.add_argument(
        "-q", "--mapq-threshold", type=int, default=C.DEFAULT_MAPQ_THRESH
    )
    p.add_argument("-Q", "--bq-threshold", type=int, default=C.MIN_QUAL)
    p.add_argument(
        "-l",
        "--max-template-length",
        type=int,
        default=C.DEFAULT_MAX_TEMPLATE_LEN,
    )
    # I/O
    p.add_argument("-O", "--output-type", choices=list("buzv"), default=None)
    p.add_argument("--report-file", default=None)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-n", "--sample", default=None)
    p.add_argument("-r", "--reference", default=None)
    p.add_argument("-C", "--contig-bed", default=None)
    p.add_argument("-s", "--contig-sizes", default=None)
    p.add_argument("-D", "--dbsnp", default=None)
    p.add_argument("-A", "--all-positions", action="store_true")
    p.add_argument("--benchmark-mode", action="store_true")
    # Model
    p.add_argument("-c", "--conversion", default=None)
    p.add_argument(
        "--reference-bias", type=float, default=C.DEFAULT_REF_BIAS
    )
    # Misc
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-t", "--threads", default=None)
    # Engine
    p.add_argument(
        "--device",
        choices=["auto", "gpu", "cpu", "numpy"],
        default="auto",
        help="compute backend for the genotype model: gpu runs it on the "
        "first GPU (an error when there is none); auto uses a GPU when "
        "one is visible and a measured race picks it",
    )
    p.add_argument(
        "--no-exact",
        action="store_true",
        help="float32 model without the float64 pass (fastest; "
        "GL may differ in the last printed digit, GQ near boundaries)",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=0,
        help="run contig-sharded across N worker processes "
        "(first-class version of the reference's per-contig runs + "
        "bcftools concat)",
    )
    # Multi-host: each host runs one process with its contig assignment
    # (LPT over the shared universe) and a uniform header; stats merge via
    # a jax.distributed psum when --coordinator is given
    p.add_argument(
        "--num-hosts", type=int, default=0,
        help="total hosts in a multi-host run",
    )
    p.add_argument(
        "--host-id", type=int, default=None,
        help="this host's id in [0, num-hosts)",
    )
    p.add_argument(
        "--coordinator", default=None,
        help="jax.distributed coordinator address host:port "
        "(enables the cross-host collective stats merge)",
    )
    return p


def args_to_config(args) -> CallerConfig:
    cfg = CallerConfig(
        input_file=args.input_file,
        reference_file=args.reference,
        output_file=args.output,
        sample_name=args.sample,
        dbsnp_file=args.dbsnp,
        report_file=args.report_file,
        contig_bed=args.contig_bed,
        contig_sizes=args.contig_sizes,
        keep_duplicates=args.keep_duplicates,
        ignore_duplicates=args.ignore_duplicates,
        keep_unmatched=args.keep_unmatched,
        haploid=args.haploid,
        blank_trim=args.blank_trim,
        all_positions=args.all_positions,
        benchmark_mode=args.benchmark_mode,
        left_trim=args.left_trim,
        right_trim=args.right_trim,
        mapq_thresh=args.mapq_threshold,
        min_qual=args.bq_threshold,
        max_template_len=args.max_template_length,
        ref_bias=args.reference_bias,
        device=args.device,
        exact=not args.no_exact,
        verbose=args.verbose,
    )
    if args.threads:
        # reference: -t calc[,input,output] extra threads
        # (parse_args.c:144-146). A lone number is auto-partitioned
        # ~4:3:3 below once the output type is known.
        try:
            parts = [int(x) for x in str(args.threads).split(",")]
        except ValueError:
            parts = []
        if len(parts) >= 3:
            cfg.threads = max(1, parts[0])
            cfg.input_threads = max(0, parts[1])
            cfg.output_threads = max(0, parts[2])
        elif len(parts) >= 1:
            # a 1- or 2-part -t is NOT an explicit distribution (the
            # reference only sets explicit_thread_distribution when all
            # three parse, parse_args.c:144); the auto-partition below
            # overrides any partial shares, matching the C binary
            cfg.threads = max(1, parts[0])
    if args.conversion:
        parts = args.conversion.split(",")
        if len(parts) != 2:
            raise SystemExit(
                "conversion option requires two comma separated values"
            )
        uc, oc = float(parts[0]), float(parts[1])
        if not (0.0 <= uc <= 1.0):
            uc = C.DEFAULT_UNDER_CONVERSION
        if not (0.0 <= oc <= 1.0):
            oc = C.DEFAULT_OVER_CONVERSION
        cfg.under_conv = uc
        cfg.over_conv = oc
    # output type: explicit flag, else guess from the file name
    # (parse_args.c:174-190)
    ft_map = {"v": C.FT_VCF, "z": C.FT_VCF_GZ, "u": C.FT_BCF, "b": C.FT_BCF_GZ}
    if args.output_type:
        cfg.out_file_type = ft_map[args.output_type]
    else:
        cfg.out_file_type = C.FT_VCF
        if cfg.output_file:
            name = cfg.output_file
            if name.endswith(".vcf.gz"):
                cfg.out_file_type = C.FT_VCF_GZ
            elif name.endswith(".bcf"):
                cfg.out_file_type = C.FT_BCF_GZ
    # refuse binary/compressed output onto a terminal (parse_args.c:187-190)
    if (
        cfg.output_file is None
        and cfg.out_file_type != C.FT_VCF
        and sys.stdout.isatty()
    ):
        print(
            "Warning: suppressing binary output to terminal "
            "(writing uncompressed VCF)",
            file=sys.stderr,
        )
        cfg.out_file_type = C.FT_VCF
    if cfg.input_threads is None:
        # auto-partition a lone -t N roughly 4:3:3 calc/input/output;
        # input/output shares exist only when those streams are
        # compressed (parse_args.c:194-213)
        in_comp = _input_is_compressed(cfg.input_file)
        out_comp = bool(cfg.out_file_type & C.FT_GZ)
        nn = 10 - (0 if in_comp else 3) - (0 if out_comp else 3)
        k = cfg.threads
        if in_comp:
            cfg.input_threads = k * 3 // nn
            k -= cfg.input_threads
            nn -= 3
        else:
            cfg.input_threads = 0
        if out_comp:
            cfg.output_threads = k * 3 // nn
            k -= cfg.output_threads
        else:
            cfg.output_threads = 0
        cfg.threads = max(1, k)
    if cfg.output_threads is None:
        cfg.output_threads = cfg.threads
    return cfg.sanitize()


def _input_is_compressed(path) -> bool:
    """True when the alignment input is BGZF/CRAM (gets an inflate pool,
    parse_args.c:196-197); plain SAM and stdin streams do not."""
    if not path or path == "-":
        return False
    import os
    import stat

    try:
        # only probe REGULAR files: reading from a FIFO / process
        # substitution would consume (or block on) the caller's stream
        if not stat.S_ISREG(os.stat(path).st_mode):
            return False
        with open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return False
    return head[:2] == b"\x1f\x8b" or head == b"CRAM"


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.reference:
        print(
            "Error in bs_call: a sequence archive is mandatory",
            file=sys.stderr,
        )
        return 1
    if not args.input_file:
        args.input_file = "-"
    cfg = args_to_config(args)
    if args.num_hosts and args.num_hosts > 1:
        if args.host_id is None or not (0 <= args.host_id < args.num_hosts):
            print(
                "--num-hosts requires --host-id in [0, num-hosts)",
                file=sys.stderr,
            )
            return 1
        if not cfg.output_file:
            print("--num-hosts requires -o (per-host output)", file=sys.stderr)
            return 1
        if args.shards and args.shards > 1:
            print(
                "--num-hosts and --shards are mutually exclusive "
                "(use shards within a single host)",
                file=sys.stderr,
            )
            return 1
        if cfg.input_file == "-":
            print(
                "--num-hosts requires a seekable input file (the header "
                "is read once for contig assignment, then the caller "
                "re-opens the input); cannot run from stdin",
                file=sys.stderr,
            )
            return 1
        from bs_call_tpu.parallel.distributed import run_multihost

        stats, ctg_stats, _wrote = run_multihost(
            cfg, args.num_hosts, args.host_id, coordinator=args.coordinator
        )
        # with a coordinator the stats are globally merged on every host;
        # host 0 writes the (single, global) report. Without one, each
        # host writes its local report beside its output.
        if cfg.report_file and stats is not None and (
            args.host_id == 0 or not args.coordinator
        ):
            from types import SimpleNamespace

            from bs_call_tpu.stats.report import write_report

            tbl = SimpleNamespace(
                contigs=[
                    SimpleNamespace(name=n, ctg_stats=cs)
                    for n, cs in ctg_stats
                ]
            )
            with open(cfg.report_file, "w") as f:
                write_report(f, cfg, stats, tbl, dbsnp=cfg.dbsnp_file)
        return 0
    if args.shards and args.shards > 1:
        if cfg.device == "gpu":
            print(
                "--shards workers run on the host; --device gpu cannot be "
                "combined with --shards",
                file=sys.stderr,
            )
            return 1
        if not cfg.output_file:
            print("--shards requires -o", file=sys.stderr)
            return 1
        if cfg.contig_bed:
            # the shard runner partitions the whole contig universe
            # itself; a user -C selection would be silently discarded
            print(
                "--shards partitions all contigs and cannot be combined "
                "with -C; run the region selection as a single process "
                "or shard externally per region",
                file=sys.stderr,
            )
            return 1
        if cfg.input_file == "-":
            print(
                "--shards requires a seekable input file (workers each "
                "read the input); cannot shard a stdin stream",
                file=sys.stderr,
            )
            return 1
        from bs_call_tpu.parallel.shard_runner import (
            run_sharded,
            shards_degrade_reason,
        )

        degrade = shards_degrade_reason(args.shards)
        if degrade is not None:
            # --shards must never be a pessimization: same output
            # bytes either way, so degrading is purely a scheduling
            # decision (the reference's per-contig workflow is likewise
            # only worth it on big-core hosts, README.md:73-76); fall
            # through to the single-process pipeline below
            print(f"bs_call: --shards {args.shards}: {degrade}",
                  file=sys.stderr)
        else:
            stats, ctg_stats = run_sharded(
                cfg,
                args.shards,
                cfg.output_file,
                collect_stats=bool(cfg.report_file),
            )
            if cfg.report_file and stats is not None:
                from types import SimpleNamespace

                from bs_call_tpu.stats.report import write_report

                tbl = SimpleNamespace(
                    contigs=[
                        SimpleNamespace(name=n, ctg_stats=cs)
                        for n, cs in ctg_stats
                    ]
                )
                with open(cfg.report_file, "w") as f:
                    write_report(
                        f, cfg, stats, tbl, dbsnp=cfg.dbsnp_file
                    )
            return 0
    stats = None
    if cfg.report_file:
        from bs_call_tpu.stats.collect import BsStats

        stats = BsStats()
    from bs_call_tpu.pipeline.runner import run_caller
    from bs_call_tpu.utils import NoGpuError

    try:
        stats, table = run_caller(cfg, stats=stats)
    except NoGpuError as e:
        # raised before any output is opened
        print(f"bs_call: --device gpu: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # downstream consumer (e.g. `| head`) closed the pipe: exit
        # quietly like a SIGPIPE'd C tool; detach stdout so interpreter
        # shutdown doesn't print a second error
        import os

        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0
    if cfg.report_file and stats is not None:
        from bs_call_tpu.stats.report import write_report

        with open(cfg.report_file, "w") as f:
            write_report(f, cfg, stats, table, dbsnp=cfg.dbsnp_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
