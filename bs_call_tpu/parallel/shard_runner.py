"""Sharded whole-genome execution.

The reference parallelizes whole-genome runs externally: one bs_call
process per contig group, uniform headers via -s, then `bcftools concat`
(README.md:73-76, process_sam_header.c:52-70). This module makes that a
first-class operation: contigs are partitioned across worker processes
(greedy longest-processing-time balancing), each worker runs the caller
restricted to its shard with a uniform header, and the driver concatenates
the VCFs in header contig order and merges the JSON stats (BsStats.merge —
the host-side psum).

Workers run on the host CPU (the native f64 engine); the stats merge
and concatenation are the only cross-worker steps.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
from typing import List, Optional, Tuple

from bs_call_tpu.config import CallerConfig


def _submit_isolated(pending, jobs):
    """One single-worker spawn executor PER job, all submitted under a
    scrubbed environment. Returns {job_index: (executor, future)}.

    Why per-job pools: a worker that dies hard (OOM-kill, segfault, the
    test fault injector's os._exit) breaks its WHOLE
    ProcessPoolExecutor — sibling futures then raise BrokenProcessPool
    even when their job never started, so a shared pool miscounts
    never-run jobs as failed attempts and a 2-crash budget can be
    consumed by one real crash (observed as a flaky retry test). With
    one pool per job, a crash is attributable to exactly that job.

    Why the JAX_PLATFORMS=cpu pin wraps the SUBMIT loop, not executor
    creation: ProcessPoolExecutor spawns its worker lazily inside
    submit(), so restoring os.environ right after the constructor would
    leak the parent environment to every worker. Workers compute on the
    host and must never open a GPU. Forking instead is not an option
    (forking after JAX backend initialization deadlocks), hence spawn."""
    from concurrent.futures import ProcessPoolExecutor

    ctx = mp.get_context("spawn")
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    out = {}
    try:
        for i in pending:
            ex = ProcessPoolExecutor(max_workers=1, mp_context=ctx)
            out[i] = (ex, ex.submit(_worker, jobs[i]))
    finally:
        if saved is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = saved
    return out


def _run_jobs_with_retry(jobs, max_retries: int = 1):
    """Run shard jobs, re-running any failed shard once before giving
    up — the analogue of re-running a crashed per-contig process in the
    reference's external workflow (SURVEY §5 failure detection: the
    contig shard is the restart/recovery unit). A worker that dies
    (OOM-kill, segfault) surfaces as BrokenProcessPool from its future;
    a Python-level error surfaces as that future's exception. Either
    way only the affected shards re-run (each job runs in its own
    single-worker pool, so one crash cannot invalidate siblings — see
    _submit_isolated). Raises the final error when a shard fails
    max_retries+1 times."""
    from concurrent.futures import BrokenExecutor

    results: dict = {}
    pending = list(range(len(jobs)))
    for attempt in range(max_retries + 1):
        submitted = _submit_isolated(pending, jobs)
        failed = []
        last_err = None
        for i, (ex, fut) in submitted.items():
            try:
                results[i] = fut.result()
            except Exception as e:  # incl. BrokenExecutor
                failed.append(i)
                last_err = e
            # a broken executor cannot be shut down cleanly on some
            # platforms; guard the shutdown itself
            try:
                ex.shutdown(wait=True, cancel_futures=True)
            except BrokenExecutor:
                pass
        if not failed:
            return [results[i] for i in range(len(jobs))]
        if attempt >= max_retries:
            raise RuntimeError(
                f"shards {failed} failed after {attempt + 1} attempts"
            ) from last_err
        import sys as _sys

        print(
            f"bs_call: retrying failed shard(s) {failed}: {last_err}",
            file=_sys.stderr,
        )
        pending = failed
    raise AssertionError("unreachable")


def _scratch_dir() -> Optional[str]:
    """Directory for shard partial outputs. Concurrent workers each
    stream out a contig-sized VCF; on disk-backed tmp those writes
    serialize behind the kernel's dirty-page throttle (measured: a
    4-shard run spending 3x its CPU time blocked in writeback). A
    tmpfs (/dev/shm) absorbs them at memory speed and the partials are
    deleted right after concat. BS_CALL_SHARD_TMP overrides; None
    falls back to the tempfile default."""
    override = os.environ.get("BS_CALL_SHARD_TMP")
    if override:
        return override
    shm = "/dev/shm"
    if os.path.isdir(shm) and os.access(shm, os.W_OK):
        return shm
    return None


def shards_degrade_reason(n_shards: int) -> Optional[str]:
    """Why --shards should auto-degrade to the single-process pipeline
    on this host, or None when sharding can pay (VERDICT r04 item 4:
    --shards must never be a pessimization).

    The single-process pipeline already parallelizes every hot section
    (ingest inflate/classify, pileup, f64 model, row formatting) across
    the native worker pool plus three pipelined stage threads — on a
    host with up to ~8 usable cores it saturates the machine by itself
    (measured: ~5 core-seconds per 600k reads fully overlapped on a
    4-core host). Worker processes then add only costs: per-worker
    spawn+import startup (~0.2-0.5 s each), N× native-library loads,
    whole-file index reads, the concat pass, and end-of-run straggler
    imbalance (BENCH_r04: 178k reads/s sharded vs 276k single on 4
    cores). Past ~8 cores the in-process pool's parallel sections cap
    out (pool ≤ 16 workers, Amdahl on the serial stage glue) and
    per-contig processes win — the reference's own production workflow
    (README.md:73-76).

    BS_CALL_FORCE_SHARDS=1 always runs the requested sharding (the
    escape hatch for measurement and for hosts where the heuristic is
    wrong)."""
    from bs_call_tpu.utils import env_flag

    if env_flag("BS_CALL_FORCE_SHARDS"):
        return None
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    try:
        ceil = int(os.environ.get("BS_CALL_SHARD_MIN_CORES", "9"))
    except ValueError:
        ceil = 9
    if cores < ceil:
        return (
            f"this host has {cores} usable cores and the in-process "
            "pipeline already saturates them; running single-process "
            "(set BS_CALL_FORCE_SHARDS=1 to shard anyway)"
        )
    return None


def partition_contigs(
    names_lens: List[Tuple[str, int]], n_shards: int
) -> List[List[str]]:
    """Greedy LPT partition by contig length."""
    shards: List[List[str]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for name, ln in sorted(names_lens, key=lambda t: -t[1]):
        i = loads.index(min(loads))
        shards[i].append(name)
        loads[i] += ln
    return [s for s in shards if s]


def _worker(args):
    (cfg_dict, shard_names, sizes_path, out_path, want_stats,
     cpu_ids) = args
    # Pin each worker to its share of the host's cores (the reference's
    # -t thread-partition analog, parse_args.c:191-213, applied across
    # processes): XLA:CPU and the pipeline threads otherwise all size
    # themselves to the full machine, and N workers x full-size thread
    # pools thrash the cache instead of parallelizing.
    if cpu_ids:
        try:
            os.sched_setaffinity(0, cpu_ids)
        except (AttributeError, OSError):
            pass
    # Workers compute on the host CPU (exact mode is the native C++ f64
    # kernel), so N workers never contend for a GPU. Importing jax here
    # would cost ~0.6s per worker, so: when jax is already imported, pin
    # via jax.config (the env var alone doesn't stick then); otherwise
    # just set the env var and let the engine skip the import entirely.
    import sys as _sys

    if "jax" in _sys.modules:
        _sys.modules["jax"].config.update("jax_platforms", "cpu")
    else:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    crash_dir = os.environ.get("BS_CALL_TEST_SHARD_CRASH")
    if crash_dir:
        # fault-injection hook (tests/test_shard_runner.py): die hard —
        # as an OOM-kill would — the FIRST time this shard runs
        marker = os.path.join(
            crash_dir, os.path.basename(out_path) + ".crashed"
        )
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("x")
            os._exit(137)
    cfg = CallerConfig(**cfg_dict)
    with tempfile.NamedTemporaryFile(
        "w", suffix=".bed", delete=False
    ) as bed:
        # whole-contig regions: 0-based bed covering each contig fully
        sizes = {}
        with open(sizes_path) as f:
            for line in f:
                n, ln = line.split("\t")[:2]
                sizes[n] = int(ln)
        for name in shard_names:
            bed.write(f"{name}\t0\t{sizes[name]}\n")
        bed_path = bed.name
    try:
        cfg.contig_bed = bed_path
        cfg.contig_sizes = sizes_path
        cfg.output_file = out_path
        stats = None
        if want_stats:
            from bs_call_tpu.stats.collect import BsStats

            stats = BsStats()
        from bs_call_tpu.pipeline.runner import run_caller

        stats, table = run_caller(cfg, stats=stats)
        # only this shard's contigs: the uniform header means the table
        # holds ALL contigs with zeroed ctg_stats for unassigned ones,
        # which would clobber other workers' real counters on merge
        mine = set(shard_names)
        ctg_stats = {
            c.name: c.ctg_stats
            for c in table.contigs
            if c.ctg_stats and c.name in mine
        }
        return pickle.dumps((stats, ctg_stats))
    finally:
        os.unlink(bed_path)


def _ensure_bam_index(path: str) -> None:
    """Build a .bai for the input BAM when none exists: every shard
    worker then seeks straight to its contigs' chunks instead of
    classifying the whole file past tid_keep (the one-pass index build
    costs far less than N workers × a full scan). Quietly skipped for
    non-BAM/unwritable inputs — workers fall back to the linear scan."""
    if not path or path == "-":
        return
    if os.path.exists(path + ".bai") or os.path.exists(path + ".csi"):
        return
    try:
        from bs_call_tpu.io.bgzf import is_gzip

        if not is_gzip(path):
            return
        import gzip

        with gzip.open(path, "rb") as f:
            if f.read(4) != b"BAM\x01":
                return
        from bs_call_tpu.io.bai import write_bai

        # build-to-temp + rename: a crash mid-write must not leave a
        # truncated .bai that later runs would trust
        tmp = f"{path}.bai.tmp{os.getpid()}"
        write_bai(path, tmp)
        os.replace(tmp, path + ".bai")
    except Exception:
        pass  # unindexable/corrupt/read-only dir: linear scan still works


def run_sharded(
    cfg: CallerConfig,
    n_shards: int,
    output_file: str,
    collect_stats: bool = False,
    pool: Optional[object] = None,
):
    """Run the caller across n_shards worker processes and concatenate.
    Returns (merged_stats, per_contig_stats) when collect_stats. Workers
    run on the host, so device=gpu is refused."""
    if cfg.device == "gpu":
        raise ValueError("shard workers run on the host; device=gpu "
                         "cannot be sharded")
    from bs_call_tpu.io.fasta import FastaIndex
    from bs_call_tpu.io.sam import open_alignment_file

    reader = open_alignment_file(cfg.input_file, native=False)
    fasta = FastaIndex(cfg.reference_file)
    # contig universe = reference ∩ SAM header (the no -C/-s reconcile)
    header_names = set(reader.header.ref_names)
    universe = [
        (e.name, e.length)
        for e in fasta.entries
        if e.name in header_names
    ]
    if hasattr(reader, "close"):
        reader.close()
    _ensure_bam_index(cfg.input_file)
    # byte-compile the package so each spawned worker reads .pyc
    # instead of re-parsing ~30 modules (~70-100 ms per worker when
    # PYTHONDONTWRITEBYTECODE suppressed the cache); compileall writes
    # the cache regardless of that flag, and a fresh cache is a no-op
    try:
        import compileall

        compileall.compile_dir(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            quiet=2,
        )
    except Exception:
        pass
    shards = partition_contigs(universe, n_shards)
    tmpdir = tempfile.mkdtemp(prefix="bs_call_shards_",
                              dir=_scratch_dir())
    sizes_path = os.path.join(tmpdir, "sizes.txt")
    with open(sizes_path, "w") as f:
        for name, ln in universe:
            f.write(f"{name}\t{ln}\n")
    from bs_call_tpu import constants as C

    cfg_dict = {
        k: getattr(cfg, k)
        for k in CallerConfig.__dataclass_fields__
    }
    cfg_dict["output_file"] = None
    # shards are written in a uniform concatenatable encoding (text VCF,
    # or raw BCF for binary outputs); the requested final encoding is
    # applied by the concat step
    final_type = cfg.out_file_type
    bcf_out = final_type in (C.FT_BCF, C.FT_BCF_GZ)
    cfg_dict["out_file_type"] = C.FT_BCF if bcf_out else C.FT_VCF
    try:
        cpus = sorted(os.sched_getaffinity(0))
    except AttributeError:
        cpus = list(range(os.cpu_count() or 1))
    jobs = []
    for i, shard in enumerate(shards):
        out_path = os.path.join(tmpdir, f"shard{i}.vcf")
        cpu_ids = (
            frozenset(cpus[i::len(shards)]) if len(cpus) >= len(shards)
            else None
        )
        jobs.append((dict(cfg_dict), shard, sizes_path, out_path,
                     collect_stats, cpu_ids))
    if pool is None:
        results = _run_jobs_with_retry(jobs)
    else:
        results = pool.map(_worker, jobs)
    # merge stats
    merged = None
    ctg_stats_all = {}
    if collect_stats:
        for blob in results:
            stats, ctg_stats = pickle.loads(blob)
            if merged is None:
                merged = stats
            else:
                merged.merge(stats)
            ctg_stats_all.update(ctg_stats)
    # concatenate in header contig order
    order = {name: i for i, (name, _) in enumerate(universe)}
    shard_order = sorted(
        range(len(shards)), key=lambda i: min(order[n] for n in shards[i])
    )
    concat_vcfs(
        [os.path.join(tmpdir, f"shard{i}.vcf") for i in shard_order],
        output_file,
        contig_order=[n for n, _ in universe],
        out_file_type=final_type,
        threads=cfg.threads,
        trusted=True,  # workers emit whole contigs in global order
    )
    ordered = [
        (name, ctg_stats_all[name])
        for name, _ in universe
        if name in ctg_stats_all
    ]
    return merged, ordered


def _text_contig_segments(path, contig_order, order):
    """Byte ranges of each contig's record run in one text-VCF shard.
    Returns (header_end, [(rank, start, end), ...]) or None when the
    file isn't plain text or its contig runs aren't in global order.

    '\\n' occurs only at line ends, so the first occurrence of
    b'\\n<name>\\t' IS the first record of <name> — located at
    memchr speed, no per-line parsing."""
    import mmap
    import os as _os

    size = _os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(2)
        if head == b"\x1f\x8b":
            return None  # compressed shard: generic path
        if size == 0:
            return 0, []
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            hdr_tail = mm.find(b"\n#CHROM")
            if hdr_tail < 0:
                # headerless or foreign: records (if any) start at 0
                header_end = 0
            else:
                nl = mm.find(b"\n", hdr_tail + 1)
                header_end = size if nl < 0 else nl + 1
            if header_end == size:
                return header_end, []

            # Contig runs are located by BINARY SEARCH on line-start
            # contig names (records of one contig are contiguous and
            # runs are emitted in file order), so a shard of any size
            # costs O(k log n) page touches instead of one memchr scan
            # per contig-universe entry over the whole file.
            hb = max(header_end - 1, 0)

            def name_at(off):
                s = mm.rfind(b"\n", hb, off) + 1
                if s < header_end:
                    s = header_end
                e = mm.find(b"\t", s)
                return mm[s:e] if e >= 0 else mm[s:size].rstrip(b"\n")

            found = []
            first = name_at(header_end)
            last = name_at(size - 2 if size >= 2 else header_end)
            pos = header_end
            cur = first
            while True:
                nm = cur.decode("utf-8", "replace")
                if nm not in order:
                    return None  # foreign contig: generic merge
                found.append((order[nm], pos))
                if cur == last:
                    break
                # next run begins at the first line that differs from
                # every name seen so far; bisect for the next distinct
                # name within (pos, size)
                lo, hi = pos, size
                nxt = None
                while lo < hi:
                    mid = (lo + hi) // 2
                    s = mm.rfind(b"\n", hb, mid + 1) + 1
                    if s < header_end:
                        s = header_end
                    if name_at(s) == cur:
                        nl = mm.find(b"\n", mid)
                        lo = size if nl < 0 else nl + 1
                    else:
                        nxt = s
                        hi = s
                if nxt is None:
                    break
                pos = nxt
                cur = name_at(nxt)
            ranks = [r for r, _ in found]
            if ranks != sorted(ranks) or len(set(ranks)) != len(ranks):
                return None  # out-of-order runs: generic merge
            segs = []
            for i, (rank, start) in enumerate(found):
                end = found[i + 1][1] if i + 1 < len(found) else size
                segs.append((rank, start, end))
            # all record bytes must be accounted for (a record of a
            # contig NOT in contig_order would be silently dropped)
            if segs and segs[0][1] != header_end:
                return None
            if not segs and header_end != size:
                return None
            return header_end, segs
        finally:
            mm.close()


def _fast_concat_text(paths, output, contig_order, order, out, raw):
    """Trusted-producer concat: raw byte-range copies of whole-contig
    record runs, ordered by global contig rank — no record parsing.
    Returns False (caller falls back) when any input doesn't qualify or
    two files both carry the same contig."""
    plans = []
    for p in paths:
        plan = _text_contig_segments(p, contig_order, order)
        if plan is None:
            return False
        plans.append(plan)
    all_segs = []
    for p, (_, segs) in zip(paths, plans):
        for rank, start, end in segs:
            all_segs.append((rank, p, start, end))
    ranks = [s[0] for s in all_segs]
    if len(set(ranks)) != len(ranks):
        return False  # a contig split across shards: record-level merge
    all_segs.sort()
    with open(paths[0], "rb") as f:
        out.write(f.read(plans[0][0]))  # header verbatim from file 0
    use_sendfile = out is raw
    for _, p, start, end in all_segs:
        with open(p, "rb") as f:
            if use_sendfile:
                raw.flush()
                n = end - start
                while n > 0:
                    sent = os.sendfile(
                        raw.fileno(), f.fileno(), end - n, n
                    )
                    if sent <= 0:
                        break
                    n -= sent
                if n > 0:  # sendfile unsupported here: plain copy
                    f.seek(end - n)
                    out.write(f.read(n))
            else:
                f.seek(start)
                left = end - start
                while left > 0:
                    chunk = f.read(min(left, 8 << 20))
                    if not chunk:
                        raise ValueError(f"{p}: truncated during concat")
                    out.write(chunk)
                    left -= len(chunk)
    return True


def concat_vcfs(paths: List[str], output: str, contig_order=None,
                out_file_type=None, threads: int = 0,
                trusted: bool = False):
    """Concatenate uniform-header shard outputs (the `bcftools concat -n`
    analogue): header from the first file, records from all, re-sorted by
    (contig order, position) across files when contig_order is given.
    Shards are text VCF (for v/z finals) or raw BCF (for u/b finals);
    the final stream is encoded per out_file_type.

    trusted=True (the in-process shard/multihost runners, whose workers
    provably emit whole contigs in global order) switches plain-text
    inputs to contig-granular raw byte copies — no per-record parse or
    sort validation; anything irregular falls back to the validated
    record-level merge below."""
    from bs_call_tpu import constants as C

    if out_file_type is None:
        out_file_type = C.FT_VCF
    if out_file_type in (C.FT_BCF, C.FT_BCF_GZ):
        return _concat_bcf(
            paths, output,
            compressed=out_file_type == C.FT_BCF_GZ, threads=threads,
        )
    import heapq

    order = (
        {n: i for i, n in enumerate(contig_order)} if contig_order else None
    )
    raw = open(output, "wb")
    if out_file_type == C.FT_VCF_GZ:
        from bs_call_tpu.io.bgzf import BgzfWriter

        out = BgzfWriter(raw, threads=threads)
    else:
        out = raw
    if trusted and order is not None:
        try:
            done = _fast_concat_text(
                paths, output, contig_order, order, out, raw
            )
        except (OSError, ValueError):
            done = False
        if done:
            if out is not raw:
                out.close()
            raw.close()
            return
        # irregular input: restart the output for the generic merge
        if out is raw:
            raw.seek(0)
            raw.truncate()
        else:
            out.close()
            raw.close()
            raw = open(output, "wb")
            out = BgzfWriter(raw, threads=threads)

    def _records(path, write_header):
        # each shard file is internally sorted by (global contig rank,
        # pos): workers call contigs in reconciled-table (= reference
        # faidx = global) order, so a lazy per-file stream is sorted and
        # a k-way heap merge is all that's needed — no buffering. A
        # foreign input that is NOT internally ordered would silently
        # merge out of order, so enforce it.
        last = (-1, -1)
        with _open_auto(path) as f:
            for line in f:
                if line.startswith(b"#"):
                    if write_header:
                        out.write(line)
                    continue
                fld = line.split(b"\t", 2)
                key = (
                    order.get(fld[0].decode(), 1 << 30),
                    int(fld[1]),
                )
                if key < last:
                    raise ValueError(
                        f"{path}: records not sorted by the header's "
                        "contig order (cannot stream-merge)"
                    )
                last = key
                yield (key[0], key[1], line)

    try:
        if order is None:
            header_done = False
            for p in paths:
                with open(p, "rb") as f:
                    for line in f:
                        if line.startswith(b"#"):
                            if not header_done:
                                out.write(line)
                            continue
                        out.write(line)
                    header_done = True
        else:
            streams = [
                _records(p, write_header=(i == 0))
                for i, p in enumerate(paths)
            ]
            # consume the header of file 0 before any merged record
            first = streams[0]
            head = next(first, None)
            if head is not None:
                streams[0] = _chain_one(head, first)
            for _, _, line in heapq.merge(
                *streams, key=lambda t: (t[0], t[1])
            ):
                out.write(line)
    finally:
        if out is not raw:
            out.close()
        raw.close()


def _chain_one(first, rest):
    yield first
    yield from rest


def _open_auto(path):
    """Binary stream; transparently inflates gzip/BGZF inputs (so
    .vcf.gz shards and compressed-BCF host outputs concat directly)."""
    import gzip

    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":
        # reopen by path: a GzipFile wrapping an open fileobj does not
        # close the underlying handle, leaking one fd per shard
        f.close()
        return gzip.open(path, "rb")
    return f


def _concat_bcf(paths: List[str], output: str, compressed: bool,
                threads: int = 0):
    """Binary concat of raw-BCF shards: uniform headers (forced by the
    contig-sizes file) make the contig dictionaries identical, so rid is
    already the global contig order — records sort by (rid, pos)."""
    import heapq
    import struct

    def _records(path):
        # stream one shard's records lazily; rid is already the global
        # contig rank (uniform headers) and shards are internally sorted
        with _open_auto(path) as f:
            head = f.read(9)
            if head[:5] != b"BCF\x02\x02":
                raise ValueError(f"{path}: not a BCF shard")
            (l_text,) = struct.unpack_from("<I", head, 5)
            f.seek(l_text, 1)
            while True:
                sizes = f.read(8)
                if len(sizes) < 8:
                    return
                ls, li = struct.unpack("<II", sizes)
                body = f.read(ls + li)
                if len(body) != ls + li:
                    raise ValueError(
                        f"{path}: truncated BCF shard (record claims "
                        f"{ls + li} bytes, got {len(body)})"
                    )
                rid, pos = struct.unpack_from("<ii", body, 0)
                yield (rid, pos, sizes + body)

    raw = open(output, "wb")
    if compressed:
        from bs_call_tpu.io.bgzf import BgzfWriter

        out = BgzfWriter(raw, threads=threads)
    else:
        out = raw
    try:
        with _open_auto(paths[0]) as f:
            head = f.read(9)
            if head[:5] != b"BCF\x02\x02":
                raise ValueError(f"{paths[0]}: not a BCF shard")
            (l_text,) = struct.unpack_from("<I", head, 5)
            out.write(head + f.read(l_text))
        for _, _, rec in heapq.merge(
            *(_records(p) for p in paths), key=lambda t: (t[0], t[1])
        ):
            out.write(rec)
    finally:
        if out is not raw:
            out.close()
        raw.close()
