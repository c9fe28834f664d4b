"""Benchmark: end-to-end per-host throughput vs the real reference binary.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The reference publishes no numbers (BASELINE.md), but it now *builds* in
this environment via tools/htslib_shim, so the baseline denominator is
measured directly: the compiled bs_call 2.1.7 run in its own production
per-host configuration (one process per contig in parallel — its
documented whole-genome workflow, README.md:73-76) on the same realistic
WGBS fixture. Both sides get their best configuration; the headline is
our best per-host reads/s, vs_baseline the ratio of the two.

If the reference build fails, the headline reports no ratio. The device
benches (kernel, end-to-end, engine modes, fused tier) follow
as stderr context lines, each in its own child process so that one
process at a time holds the GPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def make_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 30, size=(n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(counts > 0, rng.integers(20, 44, size=(n, 8)), 0).astype(
        np.int32
    )
    ref = rng.integers(0, 5, size=n).astype(np.int32)
    return counts, quals, ref


def bench_device(n=1 << 20, iters=20, passes=7, report=None):
    """Median of `passes` timing passes of the f32 genotype kernel on the
    default device; optionally fills `report` (a dict) with the
    dispersion (median and min..max)."""
    import jax
    import jax.numpy as jnp

    from bs_call_tpu.ops.genotype import ModelParams, call_genotypes

    params = ModelParams()
    counts, quals, ref = make_batch(n)
    counts = jnp.asarray(counts)
    quals = jnp.asarray(quals)
    ref = jnp.asarray(ref)
    # warmup / compile
    out = call_genotypes(counts, quals, ref, params, dtype=jnp.float32)
    jax.block_until_ready(out)
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = call_genotypes(
                counts, quals, ref, params, dtype=jnp.float32
            )
        jax.block_until_ready(out)
        rates.append(n * iters / (time.perf_counter() - t0))
    rates.sort()
    med = rates[len(rates) // 2]
    if report is not None:
        report.update(
            median=med, lo=rates[0], hi=rates[-1], passes=passes
        )
    return med


def bench_oracle(n=2000):
    from bs_call_tpu.ops import oracle

    counts, quals, ref = make_batch(n, seed=1)
    t0 = time.perf_counter()
    for i in range(n):
        oracle.calc_gt_prob(counts[i], quals[i], int(ref[i]), 0.01, 0.05, 2.0)
    dt = time.perf_counter() - t0
    return n / dt


def _make_e2e_fixture(tmp, n_reads, ctg_len, seed=0, n_contigs=1):
    """Realistic WGBS fixture (bs_call_tpu.utils.synth): ~70% proper
    pairs (some overlapping), bisulfite conversion with per-read strand
    tags, SNPs, indels, soft clips, flagged + positional duplicates,
    mixed map/base quality. With n_contigs > 1, n_reads are generated
    PER CONTIG so per-contig shard workers get equal work."""
    from bs_call_tpu.utils.synth import make_wgbs_fixture

    return make_wgbs_fixture(
        tmp, n_reads, ctg_len, seed=seed, n_contigs=n_contigs
    )


def bench_end_to_end(n_reads=30000, ctg_len=300_000, runs=3):
    """Full pipeline reads/s (exact mode, the production/parity mode,
    default --device auto) on a realistic WGBS fixture (paired+overlapping
    reads, indels, clips, dup flags, bisulfite tags); median of `runs`
    warm runs reported to stderr for context. The other engine modes are
    timed by bench_modes."""
    import os
    import sys
    import tempfile

    from bs_call_tpu.config import CallerConfig
    from bs_call_tpu.pipeline.runner import run_caller

    tmp = tempfile.mkdtemp(prefix="bsc_bench_")
    ref, bam, n_recs = _make_e2e_fixture(tmp, n_reads, ctg_len)
    out = open(os.devnull, "wb")
    times = []
    for i in range(runs + 1):  # first run warms the XLA compile cache
        cfg = CallerConfig(
            input_file=bam, reference_file=ref, benchmark_mode=True,
        )
        t0 = time.perf_counter()
        run_caller(cfg, out_fileobj=out)
        dt = time.perf_counter() - t0
        if i > 0:
            times.append(dt)
    dt = sorted(times)[len(times) // 2]
    print(
        f"end-to-end (exact, median of {runs} warm): "
        f"{n_recs/dt:.0f} reads/s, {ctg_len/dt:.0f} positions/s",
        file=sys.stderr,
    )
    return n_recs / dt


def bench_modes(n_reads=30000, ctg_len=300_000, runs=2):
    """Timed e2e of the non-default engine modes on the realistic
    fixture: --no-exact --device gpu (f32 model) and --device gpu (the
    fused f64 tier), as context lines. Each run is a CLI subprocess, one
    at a time."""
    import subprocess
    import tempfile

    tmp = tempfile.mkdtemp(prefix="bsc_modes_")
    ref, bam, n_recs = _make_e2e_fixture(tmp, n_reads, ctg_len)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p
    )}
    for label, extra in [
        ("--no-exact --device gpu (f32)", ["--no-exact", "--device", "gpu"]),
        ("--device gpu (fused f64)", ["--device", "gpu"]),
    ]:

        def one():
            r = subprocess.run(
                [sys.executable, "-m", "bs_call_tpu.cli", bam, "-r",
                 ref, "-o", os.path.join(tmp, "m.vcf"),
                 "--benchmark-mode", "-n", "S", *extra],
                capture_output=True, env=env, cwd=REPO,
                timeout=600,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    r.stderr[-400:].decode("utf-8", "replace")
                )

        try:
            rps = _timed(one, n_recs, runs=runs, warm=1)
            print(f"e2e {label}: {rps:.0f} reads/s", file=sys.stderr)
        except Exception as e:
            print(f"e2e {label} failed: {e}", file=sys.stderr)


def bench_fused(n_reads=1 << 13, rl=150, n_pos=1 << 16, iters=10):
    """Fused read-batch->call step vs host-pileup + column-transfer +
    device call: the fused step moves ~rl bytes per read H2D instead of
    ~100 bytes per pileup column, so it wins whenever transfer dominates
    (SURVEY §7.2-3/M4). Context line on stderr."""
    import sys
    import time as _t

    import jax
    import jax.numpy as jnp

    from bs_call_tpu.ops.genotype import ModelParams, call_genotypes
    from bs_call_tpu.ops.kernels.pileup_device import fused_pileup_call

    rng = np.random.default_rng(0)
    rd = np.zeros((n_reads, rl), np.uint8)
    q = rng.integers(20, 44, size=(n_reads, rl)).astype(np.uint8)
    rd[:] = (rng.integers(0, 4, size=(n_reads, rl)).astype(np.uint8)
             | (q << 2))
    starts = np.sort(
        rng.integers(0, n_pos - rl, n_reads).astype(np.int32)
    )
    ori = rng.integers(0, 2, n_reads).astype(np.int32)
    strand = rng.integers(0, 3, n_reads).astype(np.int32)
    mapq = rng.integers(20, 60, n_reads).astype(np.int32)
    refc = rng.integers(0, 5, n_pos).astype(np.int32)
    params = ModelParams()

    out = fused_pileup_call(
        rd, starts, ori, strand, mapq, refc, n_pos, 20, params
    )
    jax.block_until_ready(out)
    t0 = _t.perf_counter()
    for _ in range(iters):
        out = fused_pileup_call(
            rd, starts, ori, strand, mapq, refc, n_pos, 20, params
        )
    jax.block_until_ready(out[0])
    t_fused = (_t.perf_counter() - t0) / iters

    # unfused: host scatter-add + column transfer + device call
    from bs_call_tpu.constants import FLT_QUAL

    def host_way():
        counts2 = np.zeros((n_pos, 2, 8), np.int32)
        qual_sum = np.zeros((n_pos, 8), np.float32)
        qv = (rd >> 2).astype(np.int32)
        base = (rd & 3).astype(np.int32)
        posm = starts[:, None] + np.arange(rl, dtype=np.int32)
        sel = (qv >= 20) & (qv != FLT_QUAL)
        from bs_call_tpu.constants import BASE_TAB_ST

        cat = BASE_TAB_ST[strand[:, None], base]
        np.add.at(
            counts2,
            (posm[sel], np.broadcast_to(ori[:, None], sel.shape)[sel],
             cat[sel]),
            1,
        )
        np.add.at(qual_sum, (posm[sel], cat[sel]), qv[sel])
        counts = counts2.sum(axis=1)
        nn = counts.astype(np.float32)
        avg = qual_sum / np.where(nn > 0, nn, np.float32(1))
        quals = np.where(
            counts > 0, np.floor(np.float32(0.5) + avg), 0
        ).astype(np.int32)
        return call_genotypes(
            jnp.asarray(counts), jnp.asarray(quals), jnp.asarray(refc),
            params, dtype=jnp.float32,
        )

    outh = host_way()
    jax.block_until_ready(outh)
    t0 = _t.perf_counter()
    for _ in range(max(1, iters // 2)):
        outh = host_way()
    jax.block_until_ready(outh[0])
    t_host = (_t.perf_counter() - t0) / max(1, iters // 2)
    print(
        f"fused pileup+call: {n_reads/t_fused:.0f} reads/s "
        f"({n_pos/t_fused:.0f} pos/s) vs host-pileup+call "
        f"{n_reads/t_host:.0f} reads/s -> {t_host/t_fused:.1f}x",
        file=sys.stderr,
    )


def _build_reference_binary(build_dir="/tmp/bsref_bench"):
    """Compile the reference bs_call against tools/htslib_shim (~3 s).
    Returns the binary path, or None when the build is impossible here."""
    script = os.path.join(REPO, "tools", "htslib_shim", "build_ref.sh")
    ref_tree = os.environ.get("BS_CALL_REFERENCE", "/root/reference")
    binary = os.path.join(build_dir, "bin", "bs_call")
    if not (os.path.isdir(ref_tree) and os.path.exists(script)):
        return None
    try:
        r = subprocess.run(
            ["bash", script, ref_tree, build_dir],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0 or not os.path.exists(binary):
        print(f"reference build failed: {r.stderr[-300:]}", file=sys.stderr)
        return None
    return binary


def _timed(cmd_factory, n_items, runs=3, warm=1, timeout=600):
    """Median reads/s of `runs` timed executions after `warm` warmups.
    cmd_factory() must run one full execution (and raise on failure)."""
    times = []
    for i in range(warm + runs):
        t0 = time.perf_counter()
        cmd_factory()
        dt = time.perf_counter() - t0
        if i >= warm:
            times.append(dt)
    return n_items / sorted(times)[len(times) // 2]


def _timed_ab(contestants, n_items, rounds=4, warm=1):
    """Interleaved A/B timing: run each contestant once per round, in
    round-robin order, and score each by its BEST (min) wall time.

    Why min-of-interleaved rather than median-of-consecutive: this host
    intermittently enters multi-second kernel-time episodes (host-level
    memory-management stalls: identical runs swing 2.4s -> 24s with the
    extra time charged to sys; both our binary and the reference C
    binary are hit). The episodes only ever ADD time, so min is the
    noise-free estimator, and interleaving guarantees every contestant
    saw the same window mix. Failures score None. Per-run wall times
    are printed so BENCH files keep the dispersion visible."""
    times = {name: [] for name, _ in contestants}
    for r in range(warm + rounds):
        for name, fn in contestants:
            if times[name] is None:
                continue
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as e:
                print(f"{name} failed: {e}", file=sys.stderr)
                times[name] = None
                continue
            if r >= warm:
                times[name].append(time.perf_counter() - t0)
    out = {}
    for name, ts in times.items():
        if ts:
            out[name] = n_items / min(ts)
            print(
                f"per-host {name}: {out[name]:.0f} reads/s  "
                f"walls={[round(t, 2) for t in ts]}",
                file=sys.stderr,
            )
    return out


def bench_per_host(n_contigs=4, n_reads=150_000, ctg_len=1_250_000, runs=3):
    """Head-to-head per-host e2e: our caller (best of single-process and
    --shards N) vs the compiled reference (best of single process and
    its per-contig parallel production workflow) on one realistic
    multi-contig WGBS fixture. Returns a dict or None when the
    reference binary cannot be built."""
    import tempfile

    binary = _build_reference_binary()
    tmp = tempfile.mkdtemp(prefix="bsc_perhost_")
    ref, bam, n_recs = _make_e2e_fixture(
        tmp, n_reads, ctg_len, n_contigs=n_contigs
    )
    # index the fixture: the shim now loads the .bai and serves real
    # region iterators (round 5), so the reference's per-contig workers
    # seek to their contig instead of scanning the whole file — the
    # fairness caveat from VERDICT r04 weak #7 is closed, both sides
    # get the index
    from bs_call_tpu.io.bai import write_bai

    write_bai(bam, bam + ".bai")
    nproc = os.cpu_count() or 4
    env = {
        **os.environ,
        "PYTHONPATH": os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p
        ),
    }
    # The per-host contest is a CPU contest (the reference binary uses
    # no accelerator): our timed processes run pinned to the CPU. The
    # GPU tiers are benchmarked separately (bench_modes / bench_fused).
    # Byte-compile the package once so every timed subprocess reads
    # .pyc instead of re-parsing ~30 modules (~70-100 ms per process;
    # the session env sets PYTHONDONTWRITEBYTECODE=1, which would
    # otherwise force the recompile on every run — reading an existing
    # __pycache__ is unaffected by that flag). The C reference gets its
    # compile step in _build_reference_binary; this is ours.
    subprocess.run(
        [sys.executable, "-m", "compileall", "-q",
         os.path.join(REPO, "bs_call_tpu")],
        env={**os.environ, "PYTHONDONTWRITEBYTECODE": ""},
        capture_output=True,
    )
    host_env = dict(env)
    host_env["JAX_PLATFORMS"] = "cpu"

    # Every timed contestant writes to /dev/null: this host throttles
    # concurrent page-cache writers (ext4 wbt + host-level stalls), and
    # which contestant pays depends on the dirty-page debt left by the
    # PREVIOUS run — /dev/null keeps the contest about the pipeline.
    # (--shards workers still write real partial files, to tmpfs.)
    def py_run(extra, use_env=None):
        renv = host_env if use_env is None else use_env

        def go():
            r = subprocess.run(
                [sys.executable, "-m", "bs_call_tpu.cli", bam, "-r", ref,
                 "-o", "/dev/null", "--benchmark-mode",
                 "-n", "S", *extra],
                capture_output=True, env=renv, cwd=REPO, timeout=600,
            )
            if r.returncode != 0:
                raise RuntimeError(r.stderr[-400:].decode("utf-8", "replace"))
        return go

    # ours_shards runs the DEFAULT --shards path: on small-core hosts
    # the CLI auto-degrades it to the single-process pipeline (VERDICT
    # r04 item 4 — sharding must never be a pessimization), so this row
    # should track ours_single. The genuinely-sharded configuration is
    # timed separately below as ours_shards_forced to keep the
    # degradation decision honest in every BENCH file.
    forced_env = dict(host_env)
    forced_env["BS_CALL_FORCE_SHARDS"] = "1"
    contestants = [
        ("ours_single", py_run([])),
        ("ours_shards", py_run(["--shards", str(nproc)])),
        ("ours_shards_forced",
         py_run(["--shards", str(nproc)], use_env=forced_env)),
    ]
    if binary is not None:
        beds = []
        for i in range(1, n_contigs + 1):
            bed = os.path.join(tmp, f"chr{i}.bed")
            with open(bed, "w") as f:
                f.write(f"chr{i}\t0\t{ctg_len}\n")
            beds.append(bed)

        def c_single():
            r = subprocess.run(
                [binary, bam, "-r", ref, "-o", "/dev/null",
                 "--benchmark-mode", "-n", "S"],
                capture_output=True, timeout=600,
            )
            if r.returncode != 0:
                raise RuntimeError(r.stderr[-400:].decode("utf-8", "replace"))

        def c_perhost():
            # the reference's production per-host configuration: one
            # process per contig, all in parallel (README.md:73-76)
            procs = [
                subprocess.Popen(
                    [binary, bam, "-r", ref, "-o", "/dev/null",
                     "--benchmark-mode", "-n", "S", "-C", beds[i - 1]],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )
                for i in range(1, n_contigs + 1)
            ]
            for p in procs:
                if p.wait(timeout=600) != 0:
                    raise RuntimeError("reference shard failed")

        contestants += [
            ("ref_single", c_single),
            ("ref_perhost", c_perhost),
        ]
    return _timed_ab(contestants, n_recs, rounds=max(runs, 4))


def _kernel_line():
    disp = {}
    bench_device(report=disp)
    print(
        f"genotype kernel: {disp['median']:.3g} pos/s median of "
        f"{disp['passes']} passes, spread {disp['lo']:.3g}..{disp['hi']:.3g}"
        f" (oracle stand-in {bench_oracle():.0f} pos/s)",
        file=sys.stderr,
    )


# device benches: each runs in its own child process, one after another,
# so one process at a time holds the GPU
DEVICE_BENCHES = {
    "kernel": (_kernel_line, 600),
    "end-to-end": (bench_end_to_end, 900),
    "modes": (bench_modes, 900),
    "fused": (bench_fused, 600),
}


def _run_child_bench(name, budget):
    """Run one device bench in a child (killed at its budget); its
    context lines go to this process's stderr."""
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--bench", name],
            capture_output=True, text=True, timeout=budget, cwd=REPO,
        )
    except subprocess.TimeoutExpired:
        print(f"{name} bench timed out after {budget} s", file=sys.stderr)
        return
    sys.stderr.write(r.stderr)
    if r.returncode != 0:
        print(f"{name} bench failed (exit {r.returncode})", file=sys.stderr)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--bench":
        DEVICE_BENCHES[sys.argv[2]][0]()
        return
    headline = None
    try:
        r = bench_per_host()
        ours = max(
            v for k, v in r.items() if k.startswith("ours") and v
        )
        if "ref_single" in r or "ref_perhost" in r:
            ref_best = max(
                v for k, v in r.items() if k.startswith("ref") and v
            )
            headline = {
                "metric": "e2e_per_host_reads_per_sec",
                "value": round(ours),
                "unit": "reads/s",
                "vs_baseline": round(ours / ref_best, 2),
            }
        else:
            print("no reference binary; no headline ratio", file=sys.stderr)
    except Exception as e:
        print(f"per-host bench failed: {e}", file=sys.stderr)
    if headline is None:
        headline = {
            "metric": "e2e_per_host_reads_per_sec",
            "value": 0,
            "unit": "reads/s",
            "vs_baseline": 0.0,
        }
    # headline first so a slow context extra can't eat it
    print(json.dumps(headline), flush=True)
    for name, (_fn, budget) in DEVICE_BENCHES.items():
        _run_child_bench(name, budget)


if __name__ == "__main__":
    main()
