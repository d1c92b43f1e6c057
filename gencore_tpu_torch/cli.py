"""Command-line interface of the PyTorch/CUDA port (port of
gencore_tpu/cli.py), flag-compatible with the reference gencore CLI.

Flag table mirrors reference src/main.cpp:29-87 (same long/short names,
defaults and help semantics); `test` and `--version` subcommands mirror
main.cpp:18-27. The engine flags are the JAX CLI's, plus `--device`:

    python -m gencore_tpu_torch.cli -i in.bam -o out.bam -r ref.fa --device cuda

`--device cuda` (the default) raises on a machine without CUDA; `--device
cpu` runs the plain PyTorch path. `--devices N` deals the coordinate
windows over cuda:0..N-1 (with `--device cpu`: N times over the CPU) and
raises when the machine has fewer; `--shards N` runs N coordinate shards
in turn, with `--checkpoint_dir` keeping finished shards for a resumed run.
Every run says on one stderr line which I/O core and codec it uses and
which path it took.
"""

from __future__ import annotations

import argparse
import sys
import time

from gencore_tpu_torch.options import OptionError, Options
from gencore_tpu_torch.utils import tracing
from gencore_tpu_torch import __version__


def build_parser() -> argparse.ArgumentParser:
    # add_help=False: the reference assigns -h to --html (main.cpp:54);
    # --help is registered manually below
    p = argparse.ArgumentParser(
        prog="gencore-tpu-torch", add_help=False,
        description="consensus read engine on PyTorch/CUDA "
                    "(gencore-compatible)")
    p.add_argument("--help", action="help",
                   help="show this help message and exit")
    p.add_argument("-i", "--in", dest="input", default="-",
                   help="input sorted bam/sam file. STDIN will be read from if it's not specified")
    p.add_argument("-o", "--out", dest="output", default="-",
                   help="output bam/sam file. STDOUT will be written to if it's not specified")
    p.add_argument("-r", "--ref", dest="ref", required=False, default="",
                   help="reference fasta file name (should be an uncompressed .fa/.fasta file)")
    p.add_argument("-b", "--bed", dest="bed", default="",
                   help="bed file to specify the capturing region, none by default")
    p.add_argument("-x", "--duplex_only", action="store_true",
                   help="only output duplex consensus sequences")
    p.add_argument("--no_duplex", action="store_true",
                   help="don't merge single stranded consensus sequences to duplex")
    p.add_argument("-u", "--umi_prefix", default="auto",
                   help="the prefix for UMI, if it has. None by default.")
    p.add_argument("-s", "--supporting_reads", type=int, default=1)
    p.add_argument("-a", "--ratio_threshold", type=float, default=0.8)
    p.add_argument("-c", "--score_threshold", type=int, default=6)
    p.add_argument("-d", "--umi_diff_threshold", type=int, default=1)
    p.add_argument("-D", "--duplex_diff_threshold", type=int, default=2)
    p.add_argument("--high_qual", type=int, default=30)
    p.add_argument("--moderate_qual", type=int, default=20)
    p.add_argument("--low_qual", type=int, default=15)
    p.add_argument("--coverage_sampling", type=int, default=10000)
    p.add_argument("-j", "--json", default="gencore.json")
    p.add_argument("-h", "--html", default="gencore.html",
                   help="the html format report file name")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--quit_after_contig", type=int, default=0)
    # engine knobs (no reference counterpart)
    p.add_argument("--device", default="cuda",
                   help="torch device for the device programs: cuda "
                        "(default; raises without a CUDA device) or cpu")
    p.add_argument("--oracle", action="store_true",
                   help="use the scalar oracle engine (debugging)")
    p.add_argument("--windows", type=int, default=0,
                   help="pipeline over N coordinate windows (0 = auto; 1 = "
                        "single-shot). Host prep of window k+1 overlaps "
                        "device voting of window k")
    p.add_argument("--devices", type=int, default=1,
                   help="round-robin pipeline windows over N local GPUs "
                        "(cuda:0..N-1; raises when there are fewer)")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory mode: decode/process/write per "
                        "coordinate window (peak RSS ~ one window, not the "
                        "file); BAM-file input+output only")
    p.add_argument("--shards", type=int, default=1,
                   help="process in N coordinate shards (bounds peak memory; "
                        "same outputs as a single pass)")
    p.add_argument("--checkpoint_dir", default="",
                   help="persist completed shards for crash resume (with --shards)")
    return p


def options_from_args(args) -> Options:
    opt = Options(
        input=args.input, output=args.output, ref_file=args.ref,
        bed_file=args.bed, umi_prefix=args.umi_prefix,
        cluster_size_req=args.supporting_reads,
        base_score_req=args.score_threshold,
        score_percent_req=args.ratio_threshold,
        max_contig=args.quit_after_contig,
        high_quality=args.high_qual, moderate_quality=args.moderate_qual,
        low_quality=args.low_qual, coverage_step=args.coverage_sampling,
        proper_reads_umi_diff_threshold=args.umi_diff_threshold,
        duplex_mismatch_threshold=args.duplex_diff_threshold,
        debug=args.debug, duplex_only=args.duplex_only,
        disable_duplex=args.no_duplex,
        json_file=args.json, html_file=args.html,
    )
    opt.validate()
    return opt


def io_line(path: str) -> str:
    """The run's one line on the I/O core, its DEFLATE codec and the path
    taken (streaming, in-memory window pipeline, ...)."""
    from gencore_tpu_torch.io import native
    codec = native.codec()
    if codec is not None:
        return f"I/O: native core ({codec}), {path}"
    return (f"I/O: pure-Python codec (native core unavailable: "
            f"{native.why_not()}), {path}")


def run_unit_tests() -> bool:
    """`gencore test` equivalent (reference main.cpp:18-22, unittest.cpp:10-16)."""
    from gencore_tpu_torch.utils.umi import get_umi_from_qname, umi_diff, is_duplex
    ok = True
    vectors = [
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404", "", ""),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:UMI_GAGCATAC", "UMI", "GAGCATAC"),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:UMI_GAGC_ATAC", "UMI", "GAGC_ATAC"),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:GAGC_ATAC", "", "GAGC_ATAC"),
        ("NB551106:8:H5Y57BGX2:1:13304:3538:1404:UMI_X", "UMI", ""),
        ("@V300034954L1C001R0040000002/1:UMI_ATG_AAT", "UMI", "ATG_AAT"),
        ("@V300034954L1C001R0040000002:UMI_ATG_AAT /1", "UMI", "ATG_AAT"),
    ]
    for q, p, e in vectors:
        ok &= get_umi_from_qname(q, p) == e
    ok &= umi_diff("ATCGATCG", "ATCGATCG") == 0
    ok &= umi_diff("ATCGATCG", "ATCGTTC") == 2
    ok &= is_duplex("ATCG_CTAG", "CTAG_ATCG") is True
    ok &= is_duplex("CTAG", "CCCAGG") is False
    return ok


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and argv[0] == "test":
        if run_unit_tests():
            print("PASSED", file=sys.stderr)
            return 0
        print("FAILED", file=sys.stderr)
        return 1
    if len(argv) == 1 and argv[0] in ("-v", "--version"):
        print(f"gencore-tpu-torch {__version__}", file=sys.stderr)
        return 0

    args = build_parser().parse_args(argv)
    try:
        opt = options_from_args(args)
    except OptionError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return -1

    # spans and the memory gauge are recorded under --debug (beside the
    # stage table) and with GENCORE_TRACE_DIR (written there as spans.json)
    with tracing.recording(opt.debug), tracing.maybe_trace(), \
            tracing.sample() as peak:
        rc = _run(args, opt, argv)
    if opt.debug and peak is not None and peak.line():
        print(peak.line(), file=sys.stderr)
    return rc


def _run(args, opt, argv) -> int:
    """One run of the engine on the parsed options: the body of `main`."""
    import os

    device = None
    devices = None
    if not args.oracle:
        from gencore_tpu_torch.device import local_devices, resolve_device
        device = resolve_device(args.device)
        if args.devices > 1:
            devices = local_devices(device, args.devices)

    command = "gencore-tpu-torch " + " ".join(argv)
    t1 = time.time()

    # piped stdin: spool once to an unlinked seekable temp file so every
    # downstream path (streaming two-pass included) treats it as a file;
    # the spool is deleted on exit automatically (io/sam.spool_stdin).
    # The reference streams pipes directly (gencore.cpp:164-173).
    stdin_keeper = None
    stdin_is_bam = True
    if opt.input == "-":
        from gencore_tpu_torch.io.sam import spool_stdin
        opt.input, stdin_keeper, stdin_is_bam = spool_stdin()

    from gencore_tpu_torch.io.bed import BedRegions
    from gencore_tpu_torch.io.fasta import FastaRef

    fasta = None
    if opt.ref_file:
        print("loading reference data:", file=sys.stderr)
        with tracing.span("fasta.load"):
            fasta = FastaRef.load(opt.ref_file, opt.max_contig)
            if tracing.RECORDING:
                tracing.annotate(**fasta.load_info)
            for name, contig in fasta.contigs.items():
                print(f"{name}: {len(contig)} bp", file=sys.stderr)

    # Streaming (bounded-memory windowed decode/process/write) is the
    # DEFAULT for file->file BAM runs: the reference's only mode is
    # O(window) residency (gencore.cpp:205), and the windowed ranged
    # decode overlaps BGZF inflate with device compute. --stream forces
    # it; small inputs and unsupported shapes use the in-memory pipeline.
    # pipes stream too: stdin is already a seekable spool (above) and
    # stdout takes sequential incremental BGZF writes (no seek needed)
    stream_ok = not (opt.input.endswith("sam") or not stdin_is_bam
                     or opt.output.endswith("sam") or args.oracle
                     or args.shards > 1 or opt.max_contig > 0)
    use_stream = args.stream
    # auto-selection additionally skips --windows 1 (an explicit request
    # for a single-shot run); explicit --stream honors it
    if (not use_stream and stream_ok and args.windows != 1
            and not os.environ.get("GENCORE_NO_STREAM")):
        from gencore_tpu_torch.io import native as _nat
        from gencore_tpu_torch.parallel.streaming import \
            DEFAULT_STREAM_THRESHOLD
        thr = int(os.environ.get("GENCORE_STREAM_THRESHOLD",
                                 DEFAULT_STREAM_THRESHOLD))
        try:
            use_stream = (_nat.get_lib() is not None
                          and os.path.getsize(opt.input) >= thr)
        except OSError:
            use_stream = False
    if use_stream:
        if not stream_ok:
            print("ERROR: --stream requires BAM input and output "
                  "(no SAM/--oracle/--shards/--quit_after_contig)",
                  file=sys.stderr)
            return -1
        from gencore_tpu_torch.parallel.streaming import (StreamingBam,
                                                          run_streaming)
        try:
            with tracing.span("stream.header"):
                sb0 = StreamingBam(opt.input)
        except (ValueError, RuntimeError, OSError):
            if args.stream:
                raise
            sb0 = None  # auto-selected but not BGZF: in-memory path below
            use_stream = False
    if use_stream:
        with tracing.span("stream.header"):
            buf0, _ = sb0._read_span(0, min(1 << 20, sb0.total))
            sb0._parse_header(buf0)
            bed = None
            if opt.bed_file:
                bed = BedRegions.load(opt.bed_file, sb0.header.names)
                opt.has_bed_file = True
        stage_sum = {} if opt.debug else None
        count_sum = {} if opt.debug else None
        out_path = opt.output
        if out_path == "-":
            # incremental BGZF writes are sequential appends: route them
            # straight to stdout (reference gencore.cpp:170-173)
            sys.stdout.flush()
            out_path = "/dev/stdout"
        print(io_line("streaming path"), file=sys.stderr)
        header, pre_stats, post_stats = run_streaming(
            opt, opt.input, out_path, fasta=fasta, bed=bed,
            n_windows=args.windows, device=device, devices=devices,
            stage_totals=stage_sum, count_totals=count_sum)
        _print_tables(stage_sum, count_sum)
        _report(opt, pre_stats, post_stats, command)
        t2 = time.time()
        print(f"\n{command}", file=sys.stderr)
        print(f"gencore-tpu-torch v{__version__}, time used: "
              f"{t2 - t1:.1f} seconds", file=sys.stderr)
        return 0

    from gencore_tpu_torch.io.sam import open_alignment
    reader = open_alignment(opt.input)
    header = reader.header

    bed = None
    if opt.bed_file:
        bed = BedRegions.load(opt.bed_file, header.names)
        opt.has_bed_file = True

    class _MergedResult:
        def __init__(self, pre, post):
            self.pre_stats = pre
            self.post_stats = post

    # only a name ending in "sam" gets text mode; `-o -` writes BAM to
    # stdout exactly like the reference (gencore.cpp:170-173)
    sam_out = opt.output.endswith("sam")
    if args.shards > 1 and not args.oracle:
        from gencore_tpu_torch.parallel import windows as win

        print(io_line(f"in-memory run in {args.shards} coordinate shards"),
              file=sys.stderr)
        tables, pre_stats, post_stats = win.run_sharded(
            opt, reader.read_all(), header, fasta=fasta, bed=bed,
            n_shards=args.shards,
            checkpoint_dir=args.checkpoint_dir or None, device=device)
        engine = _MergedResult(pre_stats, post_stats)
        outs = win.merged_records(tables)
    elif args.oracle:
        from gencore_tpu_torch.core.oracle import OracleEngine as EngineCls
        print(io_line("in-memory run of the scalar oracle"), file=sys.stderr)
        engine = EngineCls(opt, header, fasta=fasta, bed=bed)
        outs = engine.run(reader.read_all())
    else:
        from gencore_tpu_torch.engine import VectorEngine
        batch = reader.read_all()
        use_pipeline = (args.windows != 1 and opt.max_contig == 0
                        and (args.windows > 1 or args.devices > 1
                             or batch.n >= 80_000))
        print(io_line("in-memory window pipeline" if use_pipeline
                      else "in-memory single-shot run"), file=sys.stderr)
        if use_pipeline:
            from gencore_tpu_torch.io import native as _native
            from gencore_tpu_torch.parallel import pipeline as pipe
            stage_sum = {} if opt.debug else None
            count_sum = {} if opt.debug else None
            out_writer = None
            if (not sam_out and opt.output != "-"
                    and _native.get_lib() is not None):
                # incremental per-window BGZF writes overlap compression
                # with later windows' host/device work
                from gencore_tpu_torch.parallel.streaming import \
                    StreamingBamWriter
                out_writer = StreamingBamWriter(opt.output, header)
            try:
                tables, pre_stats, post_stats = pipe.run_pipelined(
                    opt, batch, header, fasta=fasta, bed=bed,
                    n_windows=args.windows, device=device, devices=devices,
                    stage_totals=stage_sum, count_totals=count_sum,
                    out_writer=out_writer)
                if out_writer is not None:
                    out_writer.close()
            except BaseException:
                # the incremental writer truncated the output at start;
                # don't leave a corrupt EOF-less partial file behind
                if out_writer is not None:
                    try:
                        os.remove(opt.output)
                    except OSError:
                        pass
                raise
            if out_writer is not None:
                out_writer.timer.merge_into(stage_sum, count_sum)
            _print_tables(stage_sum, count_sum)
            engine = _MergedResult(pre_stats, post_stats)
            if out_writer is not None:
                outs = None   # written window by window
            elif sam_out:
                from gencore_tpu_torch.parallel import windows as win
                outs = win.merged_records(tables)
            else:
                outs = pipe.merged_payload(tables)
        else:
            engine = VectorEngine(opt, header, fasta=fasta, bed=bed,
                                  device=device)
            outs = engine.run(batch)

    if outs is not None:
        _write_outs(outs, opt.output, header, sam_out)

    if opt.debug and hasattr(engine, "timer"):
        for line in engine.timer.report_lines():
            print(line, file=sys.stderr)

    _report(opt, engine.pre_stats, engine.post_stats, command)

    t2 = time.time()
    print(f"\n{command}", file=sys.stderr)
    print(f"gencore-tpu-torch v{__version__}, time used: {t2 - t1:.1f} "
          "seconds", file=sys.stderr)
    return 0


def _write_outs(outs, path, header, sam_out) -> None:
    """Write an in-memory run's output records to `path`."""
    from gencore_tpu_torch.io import bam as bamio
    with tracing.span("write"):
        if sam_out:
            from gencore_tpu_torch.io.sam import SamWriter
            writer = SamWriter(path, header)
        else:
            writer = bamio.BamWriter(path, header)
        import numpy as _np
        if isinstance(outs, _np.ndarray):
            writer.write_payload(outs)
        elif hasattr(outs, "build_payload"):
            writer.write_table(outs)
        elif outs and isinstance(outs[0], bytes):
            for body in outs:
                writer.write_record(body)
        else:
            for r in outs:
                writer.write_record(r.encode())
        writer.close()


def _print_tables(stage_sum, count_sum) -> None:
    """The --debug tables of a windowed run: `[stage]` lines (seconds
    summed over windows, longest first), then `[count]` lines. The
    counter totals also go on the run's `cli.sample` span."""
    if count_sum:
        tracing.annotate(**count_sum)
    for k in sorted(stage_sum or {}, key=lambda k: -stage_sum[k]):
        print(f"[stage] {k}: {stage_sum[k]:.3f}s (summed over windows)",
              file=sys.stderr)
    for line in tracing.count_lines(count_sum or {}):
        print(line, file=sys.stderr)


def _report(opt, pre_stats, post_stats, command) -> None:
    """The run's summaries on stderr and its JSON and HTML reports."""
    from gencore_tpu_torch.report import write_html_report, write_json_report
    with tracing.span("report"):
        print("----Before gencore processing:", file=sys.stderr)
        pre_stats.print_summary(sys.stderr)
        print("\n----After gencore processing:", file=sys.stderr)
        post_stats.print_summary(sys.stderr)
        write_json_report(opt.json_file, opt, pre_stats, post_stats, command)
        write_html_report(opt.html_file, opt, pre_stats, post_stats, command)


if __name__ == "__main__":
    sys.exit(main())
