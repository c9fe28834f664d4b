"""End-to-end calling pipeline orchestration.

The streaming shape mirrors the reference's thread pipeline (process.c) but
as a simple generator chain: record stream -> block builder -> template
normalization -> pileup tensors -> device genotype batch -> site emitter.
"""

from __future__ import annotations

import sys
import numpy as np

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.io.fasta import FastaIndex, sequence_window
from bs_call_tpu.io.sam import open_alignment_file
from bs_call_tpu.output.site import SiteEmitter
from bs_call_tpu.output.vcf_writer import VcfTextWriter, build_header_lines
from bs_call_tpu.pipeline.blocks import read_blocks
from bs_call_tpu.pipeline.contigs import reconcile_contigs
from bs_call_tpu.pipeline.engine import CallEngine
from bs_call_tpu.ops.pileup import build_pileup
from bs_call_tpu.pipeline.template import process_template
from bs_call_tpu.stats.meth_profile import meth_profile


def run_caller(cfg: CallerConfig, out_fileobj=None, stats=None, dbsnp=None,
               tracer=None, device=None):
    """Run the full pipeline. Returns (stats, contig_table). `device` is
    the jax.Device of the engine's device tier (CallEngine)."""
    from bs_call_tpu.utils.trace import Tracer

    cfg.sanitize()
    # before any output is opened: --device gpu without a GPU fails here
    engine = CallEngine(cfg, device=device)
    if tracer is None:
        tracer = Tracer(enabled=cfg.verbose)
    # -t calc,input,output shares (parse_args.c:194-213): the inflate
    # pool takes the input share, the deflate pool the output share; a
    # 0/None share falls back to the calc count (our pools still need a
    # worker where the reference would decompress inline). Every share
    # is clamped to this process's CPU affinity: shard workers pinned to
    # a core subset otherwise spawn machine-sized pools that thrash
    # their one core instead of parallelizing.
    from bs_call_tpu.ops.genotype_native import _n_threads

    aff = _n_threads()
    in_threads = min(cfg.input_threads or cfg.threads, aff)
    out_threads = min(
        cfg.output_threads if cfg.output_threads else cfg.threads, aff
    )
    reader = open_alignment_file(
        cfg.input_file, threads=in_threads, reference=cfg.reference_file
    )
    fasta = FastaIndex(cfg.reference_file)
    table = reconcile_contigs(
        fasta,
        reader.header,
        cfg.contig_bed,
        cfg.contig_sizes,
        make_stats=stats is not None,
    )
    if dbsnp is None and cfg.dbsnp_file:
        from bs_call_tpu.io.dbsnp import DbSnpIndex

        dbsnp = DbSnpIndex(cfg.dbsnp_file)

    close_out = False
    if out_fileobj is None:
        if cfg.output_file:
            out_fileobj = open(cfg.output_file, "wb")
            close_out = True
        else:
            out_fileobj = sys.stdout.buffer
    # header lines must be built first: vcf_rid assignment happens here
    hdr_lines = build_header_lines(
        cfg,
        table,
        reader.header.text,
        dbsnp.header_line if dbsnp is not None else None,
    )
    from bs_call_tpu import constants as C

    if cfg.out_file_type in (C.FT_BCF, C.FT_BCF_GZ):
        from bs_call_tpu.io.bcf import BcfWriter

        writer = BcfWriter(
            out_fileobj, hdr_lines, threads=out_threads,
            compressed=cfg.out_file_type == C.FT_BCF_GZ,
        )
    elif cfg.out_file_type == C.FT_VCF_GZ:
        from bs_call_tpu.io.bgzf import BgzfWriter

        gz_writer = BgzfWriter(out_fileobj, threads=out_threads)
        writer = VcfTextWriter(gz_writer, table)
        writer.write_header(hdr_lines)
    else:
        writer = VcfTextWriter(out_fileobj, table)
        writer.write_header(hdr_lines)
    emitter = SiteEmitter(
        cfg, table, writer.write_site, stats=stats, dbsnp=dbsnp
    )
    # fast block-vectorized emission for text output (plain or bgzipped,
    # with or without stats/dbSNP); small or edge blocks still use the
    # scalar path. For .vcf.gz the vector emitter feeds the same
    # BgzfWriter as the scalar writer, so the compressed stream is
    # identical either way.
    vector_emitter = None
    if isinstance(writer, VcfTextWriter) and cfg.out_file_type in (
        C.FT_VCF,
        C.FT_UNKN,
    ):
        from bs_call_tpu.output.vector_site import VectorBlockEmitter

        vector_emitter = VectorBlockEmitter(
            cfg, out_fileobj, stats=stats, dbsnp=dbsnp
        )
    elif cfg.out_file_type == C.FT_VCF_GZ:
        from bs_call_tpu.output.vector_site import VectorBlockEmitter

        vector_emitter = VectorBlockEmitter(
            cfg, gz_writer, stats=stats, dbsnp=dbsnp
        )
    elif cfg.out_file_type in (C.FT_BCF, C.FT_BCF_GZ):
        from bs_call_tpu.native import load as _native_load
        from bs_call_tpu.output.vector_site import VectorBlockEmitter

        if _native_load() is not None:
            vector_emitter = VectorBlockEmitter(
                cfg, out_fileobj, stats=stats, dbsnp=dbsnp,
                bcf_writer=writer,
            )
    emitter.vector = vector_emitter
    engine.tracer = tracer  # -v: engine race decisions
    native = _try_native(
        cfg, table, reader=reader, collect_stats=stats is not None
    )
    if native is not None:
        tracer.progress("using native C++ ingest pipeline")
        process_contig_blocks_native(
            cfg, native, table, fasta, engine, emitter, stats, tracer
        )
    else:
        process_contig_blocks(
            cfg, reader, table, fasta, engine, emitter, stats, tracer
        )
    emitter.flush()
    writer.close()
    if close_out:
        out_fileobj.close()
    if vector_emitter is not None and stats is not None:
        # fold natively accumulated report counters into the Python
        # BsStats before anyone reports/pickles/psums it
        vector_emitter.finalize_stats(table)
    tracer.report()
    return stats, table


def _emit_block_soa(cfg, emitter, ctg, soa, ref_window, x, y,
                    hold_back=0, region=None):
    """Emit one block's already-called sites (no engine work). Sequential
    per emitter: carries the reference's 2-position lag state across
    blocks (print_vcf.c:529-594). ctg.curr_reg is owned by this (emit)
    stage — producer threads must not touch it."""
    from bs_call_tpu.pipeline.engine import soa_to_calls

    ctg.curr_reg = region
    ve = getattr(emitter, "vector", None)
    sz = y - x + 1
    # NOTE: for blocks starting at x < 5 the reference's lag pipeline can
    # carry stale genotype slots from the previous contig into the first
    # pushes (print_vcf.c:563-570 shifts without clearing); that emits
    # degenerate rows (positions <= 0) in the reference. The vectorized
    # path assumes a clean lag state instead — a deliberate divergence.
    regions_ok = not getattr(ctg, "regions", None) or all(
        r.start <= 1 and r.stop >= ctg.seq_len for r in ctg.regions
    )
    if ve is not None and sz >= 9 and regions_ok:
        ve.old_ctg = emitter.old_ctg
        ve.old_x = emitter.old_x
        ve.prev_cpg_x = emitter.prev_cpg_x
        ve.prev_cpg_flt = emitter.prev_cpg_flt
        ve.emit_block(ctg, soa, ref_window, x, y, hold_back=hold_back)
        emitter.old_ctg = ve.old_ctg
        emitter.old_x = ve.old_x
        emitter.prev_cpg_x = ve.prev_cpg_x
        emitter.prev_cpg_flt = ve.prev_cpg_flt
        return
    assert hold_back == 0  # streaming only runs on the vector path
    calls = soa_to_calls(soa)
    for i, call in enumerate(calls):
        emitter.push(ctg, call, ref_window, x + i, x, skip=call is None)
    emitter.flush()


def _emit_block(
    cfg, engine, emitter, ctg, counts2, qual_sum, mapq2_sum, ref_window,
    x, y, agg=None, region=None,
):
    """Call + emit one block serially (the non-pipelined path)."""
    sz = y - x + 1
    soa = engine.call_block_soa(
        counts2, qual_sum, mapq2_sum, ref_window[:sz], agg=agg
    )
    _emit_block_soa(cfg, emitter, ctg, soa, ref_window, x, y,
                    region=region)


def _whole_contig_regions(table) -> bool:
    """True when every -C region spans a full contig — then region
    selection degenerates to contig selection, which the native pipeline
    and the vectorized emitter handle via tid_keep."""
    return bool(table.regions) and all(
        r.start <= 1 and r.stop >= r.ctg.seq_len for r in table.regions
    )


def _pack_native_regions(cfg, table):
    """Packed int64 region table for the C++ indexed iterator (None when
    no usable .bai/.csi exists). One entry per -C region in processing
    order: 0-based query window, merged index chunks, and the previous
    same-contig regions whose records were already yielded — the exact
    replay of _indexed_region_records / the reference's per-region
    sam_itr_queryi loop (get_template_vector.c:69-101)."""
    import os

    try:
        if os.path.exists(cfg.input_file + ".bai"):
            from bs_call_tpu.io.bai import BaiIndex

            idx = BaiIndex(cfg.input_file + ".bai")
        elif os.path.exists(cfg.input_file + ".csi"):
            from bs_call_tpu.io.csi import CsiIndex

            idx = CsiIndex(cfg.input_file + ".csi")
        else:
            return None
    except (ValueError, OSError):
        return None
    out = [len(table.regions)]
    for reg in table.regions:
        tid = reg.ctg.bam_tid
        beg, end = reg.start - 1, reg.stop
        chunks = idx.chunks_for(tid, beg, end)
        prev = [
            (r.start, r.stop)
            for r in reg.ctg.regions
            if r.stop < reg.start
        ]
        out += [tid, beg, end, len(chunks), len(prev)]
        for cb, ce in chunks:
            out += [cb, ce]
        for lo, hi in prev:
            out += [lo, hi]
    return np.asarray(out, dtype=np.int64)


def _pack_stream_regions(table):
    """[n, (tid, start, stop) * n] int64, 1-based inclusive — the
    sequential -C filter table for bsp_set_stream_regions (the C++ twin
    of blocks.region_filtered_records)."""
    out = [len(table.regions)]
    for reg in table.regions:
        out += [reg.ctg.bam_tid, reg.start, reg.stop]
    return np.asarray(out, dtype=np.int64)


def _try_native(cfg, table, reader=None, collect_stats=False):
    """The C++ pipeline handles whole-file runs and every -C region
    kind: indexed BAMs replay regions through BAI/CSI chunk seeks
    (including the whole-contig shard pattern, where they also seek
    past other contigs' records); non-indexed BAMs get a .bai built on
    the fly when the directory is writable; everything else (read-only
    non-indexed BAM, CRAM, SAM, gz-SAM) runs the C++ sequential stream
    filter — the same record-overlap semantics, without seeks. BAM
    files stream through the C++ decoder directly; CRAM and SAM decode
    host-side and feed the same block builder through push mode; stdin
    BAM pipes forward their decompressed bytes verbatim (stdin with
    partial regions stays on the Python pre-filter path)."""
    if cfg.device == "numpy" or not cfg.input_file:
        return None
    partial = bool(table.regions) and not _whole_contig_regions(table)
    regions_payload = None
    if table.regions and cfg.input_file != "-":
        regions_payload = _pack_native_regions(cfg, table)
        if regions_payload is None and partial:
            # no .bai/.csi: build one beside the input when possible —
            # the indexed replay then seeks instead of scanning
            from bs_call_tpu.parallel.shard_runner import (
                _ensure_bam_index,
            )

            _ensure_bam_index(cfg.input_file)
            regions_payload = _pack_native_regions(cfg, table)
    stream_regions = None
    if partial and regions_payload is None:
        stream_regions = _pack_stream_regions(table)
    try:
        from bs_call_tpu.native.pipeline import (
            NativeBamStreamPipeline,
            NativePipeline,
            NativePushPipeline,
        )
    except (OSError, RuntimeError, ImportError):
        return None
    tid_keep = _tid_keep(table)
    from bs_call_tpu.ops.genotype_native import _n_threads

    in_threads = min(cfg.input_threads or cfg.threads, _n_threads())

    def with_regions(p):
        # sequential -C filter for input kinds with no usable index
        if stream_regions is not None:
            p.set_stream_regions(stream_regions)
        return p

    if cfg.input_file == "-":
        # stdin: forward the already-positioned stream (past the header)
        # to the native parser — BAM bytes verbatim, SAM text via the
        # C++ sam_mode line parser; partial -C runs through the C++
        # stream region filter like any other unindexed input
        from bs_call_tpu.io.bam import BamReader
        from bs_call_tpu.io.sam import SamReader

        try:
            if isinstance(reader, BamReader):
                return with_regions(NativeBamStreamPipeline(
                    reader._f, reader.header, cfg, tid_keep,
                    collect_stats=collect_stats, threads=in_threads,
                ))
            if isinstance(reader, SamReader) and reader.header.ref_names:
                from bs_call_tpu.native.pipeline import (
                    NativeSamStreamPipeline,
                )

                return with_regions(NativeSamStreamPipeline(
                    reader._f, reader._pending, reader.header, cfg,
                    tid_keep, collect_stats=collect_stats,
                    threads=in_threads,
                ))
        except (RuntimeError, ValueError, OSError):
            return None
        return None
    try:
        from bs_call_tpu.io.bgzf import is_gzip

        with open(cfg.input_file, "rb") as f:
            magic = f.read(4)
    except OSError:
        return None
    is_bam = False
    if is_gzip(cfg.input_file):
        import gzip

        with gzip.open(cfg.input_file, "rb") as f:
            is_bam = f.read(4) == b"BAM\x01"
    try:
        if is_bam:
            return with_regions(NativePipeline(
                cfg.input_file, cfg, tid_keep,
                collect_stats=collect_stats, threads=in_threads,
                regions=regions_payload,
            ))
        if magic == b"CRAM":
            # fully native record path: C++ slice decoder -> C++ builder
            from bs_call_tpu.native.pipeline import NativeCramPipeline

            windows = None
            if table.regions:
                # container/slice pruning for -C: skip decoding data
                # provably outside every window (record-level filtering
                # still runs in the C++ stream filter / tid_keep)
                windows = {}
                for reg in table.regions:
                    windows.setdefault(reg.ctg.bam_tid, []).append(
                        (reg.start, reg.stop)
                    )
            try:
                return with_regions(NativeCramPipeline(
                    cfg.input_file, cfg, tid_keep,
                    collect_stats=collect_stats, threads=in_threads,
                    reference=cfg.reference_file,
                    region_windows=windows,
                ))
            except Exception:
                pass  # unsupported layout: Python record decode below
        if magic != b"CRAM" and not is_bam and reader is not None:
            # SAM text (plain or gzip): fully native line parser
            from bs_call_tpu.native.pipeline import NativeSamPipeline

            try:
                return with_regions(NativeSamPipeline(
                    cfg.input_file, reader.header, cfg, tid_keep,
                    collect_stats=collect_stats, threads=in_threads,
                ))
            except Exception:
                pass  # fall through to the Python record decode
        if magic == b"CRAM" or reader is not None:
            # push mode: host decode (CRAM/SAM/gz-SAM) -> C++ builder
            def factory():
                return open_alignment_file(
                    cfg.input_file, native=False, threads=in_threads,
                    reference=cfg.reference_file,
                )

            header = (reader or factory()).header
            return with_regions(NativePushPipeline(
                factory, header, cfg, tid_keep,
                collect_stats=collect_stats, threads=in_threads,
            ))
    except (RuntimeError, ValueError, OSError):
        return None
    return None


def _tid_keep(table):
    """int8 mask over bam tids of contigs to process; with regions, only
    contigs that actually have a region are processed."""
    max_tid = max((c.bam_tid for c in table.contigs), default=-1)
    tid_keep = np.zeros(max_tid + 1, dtype=np.int8)
    for c in table.contigs:
        if table.regions and not c.regions:
            continue
        tid_keep[c.bam_tid] = 1
    return tid_keep


def process_contig_blocks_native(
    cfg, npipe, table, fasta, engine, emitter, stats, tracer=None
):
    """Native-pipeline driver: C++ produces (x, y, pileup tensors) blocks;
    Python does reference windows, genotype batches and emission."""
    # re-open with stats collection if needed (no-op when the pipeline
    # was already created with stats on, e.g. non-reopenable stdin pipes)
    if stats is not None and not npipe.stats_on:
        npipe = npipe.reopen(collect_stats=True)
    import queue
    import threading

    from bs_call_tpu.utils.trace import NULL_TRACER

    tracer = tracer or NULL_TRACER
    contig_seq = None
    # settled-prefix partial staging: only with the vector emitter (the
    # hold_back streaming contract) and whole-contig processing. -C
    # regions that each span a full contig (the shard-worker pattern)
    # behave like plain contig processing modulo the indexed seek, so
    # they stage partials too — otherwise a dense whole-contig region
    # becomes ONE giant block and the worker faults contig-sized
    # buffers (hundreds of MB of sys time per shard).
    if (
        getattr(emitter, "vector", None) is not None
        and (not table.regions or _whole_contig_regions(table))
        and hasattr(npipe, "set_partial")
    ):
        npipe.set_partial(2 * max(cfg.batch_positions, 1024))
    # Host row engine (native/rowengine.py): when the run is host-bound
    # (exact mode, no accelerator in play) and the output is text VCF
    # without dbSNP, the whole per-block path after ingest — pileup,
    # aggregate, f64 model, Fisher, emit prep, report stats, row
    # formatting — runs as three native calls per block, with Python
    # resolving only likelihood ties through the scalar oracle. Blocks
    # the engine can't take (sz < 9) fall through to the regular path;
    # output bytes are identical either way (tests/test_rowengine.py).
    from bs_call_tpu.utils import env_flag as _env_flag

    rowe = None
    ve = getattr(emitter, "vector", None)
    if (
        _env_flag("BS_CALL_ROW_ENGINE", default=True)
        and ve is not None
        and ve._bcf is None
        and getattr(emitter, "dbsnp", None) is None
        and cfg.exact
        # partial -C windows gate emission per site (print_vcf.c:156);
        # bsre_emit has no region gate, so those runs must take the
        # _emit_block_soa path whose emitters apply ctg.regions
        and (not table.regions or _whole_contig_regions(table))
        and not engine.wants_reads()
        and not engine._prefer_xla_f64()
    ):
        try:
            acc = None
            if stats is not None:
                from bs_call_tpu.stats.native_acc import NativeStatsAcc

                acc = NativeStatsAcc.create(quirks=cfg.reference_quirks)
                if acc is None:  # BS_CALL_PY_STATS or no native lib
                    raise RuntimeError("native stats acc unavailable")
            from bs_call_tpu.native.rowengine import HostRowEngine

            rowe = HostRowEngine(cfg, stats_acc=acc)
            if acc is not None:
                ve._nacc = acc
                ve._nacc_tried = True
            tracer.progress("using native row engine")
        except Exception:
            rowe = None
    # background ingest: the C++ pipeline releases the GIL, so block
    # production overlaps with calling + emission (the reference's
    # reader-thread / process-thread split, process.c:43-72). Contig
    # loading and the meth profile also live here: bsp_block_meth_profile
    # references the pipeline's *staged* block, which stays valid exactly
    # until this thread's next next_block call (the reference's
    # mprof_thread, process.c:20-41). The loaded contig rides the block
    # dict so the consumer never touches the FastaIndex.
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()  # consumer error: producer must exit before
    # npipe.close() or bsp_next_block races the C++ teardown

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    free_slots: "queue.Queue" = queue.Queue()
    if rowe is not None:
        for _s in range(rowe.N_SLOTS):
            free_slots.put(_s)

    def _get_slot():
        while not stop.is_set():
            try:
                return free_slots.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def produce():
        pseq = None
        try:
            while True:
                if hasattr(npipe, "next_block_meta"):
                    b = npipe.next_block_meta()
                else:
                    b = npipe.next_block()
                if b is None:
                    _put(None)
                    return
                cname = table.contigs[table.tid2id[b["tid"]]].name
                if pseq is None or pseq.name != cname:
                    pseq = fasta.load_contig(
                        cname, calc_gc=stats is not None
                    )
                collected = "counts2" in b
                sz = b["y"] - b["x"] + 1
                use_row = (
                    rowe is not None
                    and not collected
                    and sz >= 9
                    and not engine.wants_reads()
                )
                if use_row:
                    slot = _get_slot()
                    if slot is None:
                        return
                    refw = sequence_window(pseq, b["x"], sz + 2)
                    with tracer.stage("ingest_load"):
                        rowe.load(slot, npipe, b["x"], b["y"], refw)
                    b["kind"] = "row"
                    b["slot"] = slot
                elif not collected:
                    b = npipe._collect_block()
                b["seq"] = pseq
                # fused device tier: export the staged block's read
                # batch (valid only until the next next_block call, so
                # it must be copied out here). wants_reads() flips off
                # if the auto race later picks a column engine.
                if engine.wants_reads() and b.get("kind") != "row":
                    b["reads"] = npipe.block_reads()
                if stats is not None:
                    with tracer.stage("meth_prof"):
                        mx = b.get("meth_x", b["x"])
                        rw = sequence_window(
                            pseq, mx, b["y"] - mx + 3
                        )
                        stats.grow_meth_profile(b["max_pos"] + 1)
                        npipe.block_meth_profile(rw, stats.meth_profile)
                if not _put(b):
                    return
        except Exception as e:  # surface errors on the consumer side
            _put(e)

    import os as _dbg_os
    if _dbg_os.environ.get("BSC_THREAD_RUSAGE"):
        import resource as _res, sys as _dbg_sys

        def _rusage_wrap(fn, label):
            def run():
                try:
                    fn()
                finally:
                    ru = _res.getrusage(_res.RUSAGE_THREAD)
                    print(f"RUSAGE {label} pid={_dbg_os.getpid()} "
                          f"user={ru.ru_utime:.2f} sys={ru.ru_stime:.2f}",
                          file=_dbg_sys.stderr, flush=True)
            return run
        produce = _rusage_wrap(produce, "producer")
    t = threading.Thread(target=produce, daemon=True)
    t.start()
    # emit stage runs on its own thread (the reference's print_thread,
    # process.c:74-110): formatting/writing block k overlaps the engine
    # call for block k+1. A single ordered worker keeps the 2-position
    # lag and CpG-pair state sequential. Block arrays are host copies
    # (native/pipeline.py next_block), so no aliasing with the C++ side.
    emit_q: "queue.Queue" = queue.Queue(maxsize=4)
    emit_err: list = []

    def emit_worker():
        while True:
            item = emit_q.get()
            if item is None:
                return
            if item[0] == "row":
                _, slot, ctg_r, partial_r = item
                if not emit_err:
                    try:
                        with tracer.stage("emit"):
                            rowe.emit(
                                slot, emitter, ctg_r,
                                2 if partial_r else 0,
                                stats is not None, ve._f,
                            )
                    except Exception as e:
                        emit_err.append(e)
                free_slots.put(slot)
                continue
            if emit_err:
                continue  # drain so the producer can't block
            try:
                with tracer.stage("emit"):
                    _emit_block_soa(cfg, emitter, *item[1])
            except Exception as e:
                emit_err.append(e)

    if _dbg_os.environ.get("BSC_THREAD_RUSAGE"):
        emit_worker = _rusage_wrap(emit_worker, "emit")
    et = threading.Thread(target=emit_worker, daemon=True)
    et.start()
    try:
        while True:
            with tracer.stage("ingest"):
                blk = q.get()
            if isinstance(blk, Exception):
                raise blk
            if blk is None:
                break
            ctg = table.contigs[table.tid2id[blk["tid"]]]
            if contig_seq is None or contig_seq.name != ctg.name:
                tracer.progress(f"Processing contig {ctg.name}")
                contig_seq = blk["seq"]
                ctg.gc_start_pos = contig_seq.start_pos
                if ctg.ctg_stats is not None:
                    ctg.ctg_stats.gc = contig_seq.gc_bins
            x, y = blk["x"], blk["y"]
            sz = y - x + 1
            tracer.count("blocks")
            tracer.count("templates", blk["n_templates"])
            tracer.count("positions", sz)
            if blk.get("kind") == "row":
                with tracer.stage("call"):
                    rowe.model(blk["slot"])
                if emit_err:
                    raise emit_err[0]
                emit_q.put(
                    ("row", blk["slot"], ctg, blk.get("partial", False))
                )
                continue
            ref_window = sequence_window(contig_seq, x, sz + 2)
            # stream big blocks through the emit worker in chunks so the
            # engine batch for chunk j+1 overlaps the formatting of chunk
            # j even when the whole contig is one semantic block (dense
            # WGBS coverage rarely breaks blocks). Chunks overlap by 4
            # positions: 2 withheld lookahead rows + the 2-before context
            # the next chunk re-supplies (see emit_block hold_back).
            CHUNK = max(cfg.batch_positions, 1024)
            stream = (
                getattr(emitter, "vector", None) is not None
                and sz > CHUNK + 16
                and not getattr(ctg, "regions", None)
            )
            agg = blk.get("agg")
            # a partial staged range is a chunk of a still-open block:
            # its last rows stay held back (the next range re-supplies
            # the 4-row overlap, exactly like the in-range chunks below)
            partial = blk.get("partial", False)
            s = x
            while True:
                if stream and y - s + 1 > CHUNK + 16:
                    e = s + CHUNK - 1
                    hold = 2
                else:
                    e = y
                    hold = 2 if partial else 0
                sl = slice(s - x, e - x + 1)
                sub_agg = (
                    {k: v[sl] for k, v in agg.items()} if agg else None
                )
                rd_blk = blk.get("reads")
                with tracer.stage("call"):
                    soa = engine.call_block_soa(
                        blk["counts2"][sl], blk["qual_sum"][sl],
                        blk["mapq2_sum"][sl],
                        ref_window[s - x : e - x + 1], agg=sub_agg,
                        reads=(rd_blk, s - x) if rd_blk else None,
                    )
                if emit_err:
                    raise emit_err[0]
                emit_q.put((
                    "py",
                    (ctg, soa, ref_window[s - x : e - x + 3], s, e, hold),
                ))
                if e == y:
                    break
                s = e - 3
        emit_q.put(None)
        et.join()
        if emit_err:
            raise emit_err[0]
        if stats is not None:
            fc, fb, bf = npipe.get_stats()
            stats.filter_cts += fc
            stats.filter_bases += fb
            stats.base_filter += bf
    finally:
        if et.is_alive():
            emit_q.put(None)
        # the producer may be blocked on q.put or inside next_block;
        # closing npipe under it would free the C++ pipeline it is using
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.05)
        et.join(timeout=10)  # emitter writes to caller-owned fileobj
        npipe.close()
        if rowe is not None:
            rowe.close()


def _indexed_region_records(cfg, table):
    """Per-region record iteration through a .bai/.csi index (the
    reference's sam_itr_queryi path, get_template_vector.c:69-101).
    Returns None when no usable index exists. Records starting inside an
    earlier region of the same contig are skipped (they were already
    yielded there)."""
    import os

    if not cfg.input_file or not (
        os.path.exists(cfg.input_file + ".bai")
        or os.path.exists(cfg.input_file + ".csi")
    ):
        return None
    try:
        from bs_call_tpu.io.bai import IndexedBamReader

        idx = IndexedBamReader(cfg.input_file)
    except (ValueError, OSError):
        return None

    def gen():
        try:
            for reg in table.regions:
                prev = [
                    r
                    for r in reg.ctg.regions
                    if r.stop < reg.start
                ]
                for rec in idx.query(
                    reg.ctg.bam_tid, reg.start - 1, reg.stop
                ):
                    if any(
                        p.start <= rec.pos + 1 <= p.stop for p in prev
                    ):
                        continue
                    rec.region = reg
                    yield rec
        finally:
            idx.close()

    return gen()


def process_contig_blocks(cfg, reader, table, fasta, engine, emitter, stats,
                          tracer=None):
    """Python-path driver (SAM/CRAM/stdin/partial regions): same 3-stage
    thread pipeline as the native driver — block building + template
    normalization + pileup on a producer thread, engine batches on this
    thread, ordered emission on an emit worker."""
    import queue
    import threading

    from bs_call_tpu.utils.trace import NULL_TRACER

    tracer = tracer or NULL_TRACER
    records = iter(reader)
    prefiltered = False
    if table.regions:
        indexed = _indexed_region_records(cfg, table)
        if indexed is not None:
            records = indexed
            prefiltered = True

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        contig_seq = None
        try:
            for block in read_blocks(
                records, table, cfg, stats=stats, prefiltered=prefiltered
            ):
                ctg = block.ctg
                if contig_seq is None or contig_seq.name != ctg.name:
                    contig_seq = fasta.load_contig(
                        ctg.name, calc_gc=stats is not None
                    )
                    ctg.gc_start_pos = contig_seq.start_pos
                    if ctg.ctg_stats is not None:
                        ctg.ctg_stats.gc = contig_seq.gc_bins
                y = block.y
                first = block.align_list[0]
                x = first.forward_position or first.reverse_position
                assert 0 < x <= y
                x = x - 2 if x > 2 else 1
                sz = y - x + 1
                ref_window = sequence_window(contig_seq, x, sz + 2)
                with tracer.stage("normalize"):
                    for al in block.align_list:
                        orig_pos, max_pos = process_template(
                            al,
                            cfg.left_trim,
                            cfg.right_trim,
                            stats=stats,
                            min_qual=cfg.min_qual,
                        )
                        if stats is not None:
                            meth_profile(
                                al, x, orig_pos, max_pos, ref_window,
                                stats,
                            )
                with tracer.stage("pileup"):
                    counts2, qual_sum, mapq2_sum = build_pileup(
                        block.align_list, x, y, cfg.min_qual
                    )
                if not _put(
                    (ctg, block.region, counts2, qual_sum, mapq2_sum,
                     ref_window, x, y)
                ):
                    return
            _put(None)
        except Exception as e:
            _put(e)

    emit_q: "queue.Queue" = queue.Queue(maxsize=4)
    emit_err: list = []

    def emit_worker():
        while True:
            item = emit_q.get()
            if item is None:
                return
            if emit_err:
                continue
            try:
                with tracer.stage("emit"):
                    _emit_block_soa(cfg, emitter, *item)
            except Exception as e:
                emit_err.append(e)

    t = threading.Thread(target=produce, daemon=True)
    et = threading.Thread(target=emit_worker, daemon=True)
    t.start()
    et.start()
    try:
        while True:
            with tracer.stage("ingest"):
                blk = q.get()
            if isinstance(blk, Exception):
                raise blk
            if blk is None:
                break
            (ctg, region, counts2, qual_sum, mapq2_sum, ref_window,
             x, y) = blk
            sz = y - x + 1
            tracer.count("blocks")
            tracer.count("positions", sz)
            with tracer.stage("call"):
                soa = engine.call_block_soa(
                    counts2, qual_sum, mapq2_sum, ref_window[:sz]
                )
            if emit_err:
                raise emit_err[0]
            emit_q.put((ctg, soa, ref_window, x, y, 0, region))
        emit_q.put(None)
        et.join()
        if emit_err:
            raise emit_err[0]
    finally:
        if et.is_alive():
            emit_q.put(None)
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.05)
        et.join(timeout=10)
