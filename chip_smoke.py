#!/usr/bin/env python3
"""Smoke test of bs_call_tpu on NVIDIA GPUs.

Usage, from the root of a checkout:

    python3 chip_smoke.py             # one card: every phase below
    python3 chip_smoke.py --cards 4   # four cards: the mesh path only

Drives the caller's main path through its CLI on a synthetic WGBS fixture
(utils/synth.py: 4 contigs of 2.5 Mbp, 500k records each, ~30x of 150 bp
reads, seed 1, plus a dbSNP index; cached under .cache/smoke/) and checks
it against the host run (--device cpu under JAX_PLATFORMS=cpu: the native
C++ f64 engine plus the scalar oracle, independent of the device code).
Phases:

  gpu-exact  --device gpu, VCF and -O b: the VCF bytes, the decompressed
             BCF and the JSON report (minus its date) equal the host run's
  auto       --device auto -v: the same byte equality; prints the engine
             the race picked
  f32        --no-exact --device gpu: within utils/vcfcmp.py's tolerance
  kernels    each device kernel at real widths (n_pos 32768+64, one
             block's read batch padded to its own r_pad and to 16384,
             l_cap 256) against its host reference, with
             compiled.memory_analysis()
  gpu-tests  the test suite's `gpu`-marked tests

The forced-GPU runs also read the engine's -v counters and fail unless the
fused tier carried every chunk (fused_chunks > 0, no fused_declined).

With --cards 4 it runs only the 4-GPU mesh path and its host comparison:
sharded_fused_ll_f64 at real widths against the host pileup and model,
then the CLI with --device gpu (which engages the mesh when several GPUs
are visible) against the host run.

Every phase runs in a child process, one after another; this process never
imports jax, so only one process at a time holds the cards. Any failure
exits non-zero and never prints "ok": true. The last line of stdout is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = dict(n_contigs=4, ctg_len=2_500_000, n_reads=500_000, seed=1)
N_POS = 32768 + 64  # the engine's fused width at batch_positions 32768
L_CAP = 256


class Failed(Exception):
    pass


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p
    )
    env.update(extra)
    return env


def _run(cmd, label, timeout, **env):
    """Run one child to completion (killed at `timeout`); prints its wall
    time and returns the CompletedProcess. A non-zero exit fails."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            cmd, cwd=HERE, env=_env(**env), capture_output=True,
            text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired as e:
        raise Failed(f"{label}: killed after {timeout} s") from e
    dt = time.perf_counter() - t0
    print(f"[{label}] exit {r.returncode}, wall {dt:.2f} s", flush=True)
    if r.returncode != 0:
        raise Failed(
            f"{label} exited {r.returncode}:\n{r.stdout[-3000:]}\n"
            f"{r.stderr[-6000:]}"
        )
    return r


def _child(name, *args, timeout=600, **env):
    return _run(
        [sys.executable, os.path.abspath(__file__), "--child", name,
         *args],
        name, timeout, **env,
    )


def _cli(label, fx, out, *extra, report=None, timeout=600, **env):
    cmd = [
        sys.executable, "-m", "bs_call_tpu.cli", fx["bam"], "-r", fx["ref"],
        "-D", fx["dbsnp"], "--benchmark-mode", "-o", out, *extra,
    ]
    if report:
        cmd += ["--report-file", report]
    return _run(cmd, label, timeout, **env)


def _read(path, gz=False):
    with (gzip.open if gz else open)(path, "rb") as f:
        return f.read()


def _report_sans_date(path):
    return b"".join(
        ln for ln in _read(path).splitlines(True)
        if not ln.lstrip().startswith(b'"date"')
    )


def _same(label, got, want):
    if got != want:
        raise Failed(f"{label}: bytes differ from the host run")
    print(f"[{label}] equal to the host run ({len(want)} bytes)")


# ---------------------------------------------------------------------------
# parent phases


def _devices():
    r = _child("devices", timeout=300)
    info = json.loads(r.stdout.strip().splitlines()[-1])
    if info["platform"] != "gpu":
        raise Failed(
            f"no GPU visible to JAX (platform {info['platform']})"
        )
    print(f"jax.devices(): {info['repr']}")
    return info


def _nvidia_smi():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise Failed(f"nvidia-smi: {e}") from e
    if r.returncode != 0:
        raise Failed(f"nvidia-smi exited {r.returncode}: {r.stderr}")
    for line in r.stdout.strip().splitlines():
        print(f"card: {line.strip()}")


def _fixture():
    key = "wgbs-c{n_contigs}-l{ctg_len}-r{n_reads}-s{seed}".format(
        **FIXTURE
    )
    d = os.path.join(HERE, ".cache", "smoke", key)
    fx = {
        "dir": d,
        "ref": os.path.join(d, "ref.fa"),
        "bam": os.path.join(d, "in.bam"),
        "dbsnp": os.path.join(d, "dbsnp.idx"),
    }
    if not os.path.exists(os.path.join(d, "done")):
        _child("fixture", d, timeout=900, JAX_PLATFORMS="cpu")
    with open(os.path.join(d, "done")) as f:
        fx["records"] = int(f.read())
    print(
        f"fixture: {FIXTURE['n_contigs']} contigs x "
        f"{FIXTURE['ctg_len']:,} bp, {fx['records']:,} records, seed "
        f"{FIXTURE['seed']} (scale cut: a human chromosome is 50-250 Mbp)"
    )
    return fx


def _host_runs(fx, out, bcf=True):
    _cli("host-vcf", fx, f"{out}/host.vcf", "--device", "cpu",
         report=f"{out}/host.json", JAX_PLATFORMS="cpu")
    if bcf:
        _cli("host-bcf", fx, f"{out}/host.bcf", "--device", "cpu",
             "-O", "b", JAX_PLATFORMS="cpu")


def _check_exact(label, out, name):
    _same(f"{label} VCF", _read(f"{out}/{name}.vcf"),
          _read(f"{out}/host.vcf"))
    _same(f"{label} report", _report_sans_date(f"{out}/{name}.json"),
          _report_sans_date(f"{out}/host.json"))


def _trace_lines(stderr, *prefixes):
    return [ln for ln in stderr.splitlines() if ln.startswith(prefixes)]


def _check_fused(label, stderr):
    """The engine's -v counters: the fused tier must have carried every
    chunk of a forced-GPU run (a declined chunk runs the column kernel,
    which gives the same bytes, so byte equality alone cannot tell)."""
    counts = {}
    for ln in stderr.splitlines():
        f = ln.split()
        if len(f) >= 2 and f[0].startswith("fused_") and f[1].isdigit():
            counts[f[0]] = int(f[1])
    for ln in _trace_lines(stderr, "fused tier:"):
        print(f"[{label}] {ln}")
    print(f"[{label}] counters {counts}")
    if counts.get("fused_chunks", 0) == 0 or counts.get("fused_declined"):
        raise Failed(f"{label}: the fused tier did not carry every chunk")


def one_card(out):
    fx = _fixture()
    _host_runs(fx, out)
    r = _cli("gpu-exact-vcf", fx, f"{out}/gpu.vcf", "--device", "gpu",
             "-v", report=f"{out}/gpu.json")
    _check_fused("gpu-exact-vcf", r.stderr)
    _check_exact("gpu-exact", out, "gpu")
    r = _cli("gpu-exact-bcf", fx, f"{out}/gpu.bcf", "--device", "gpu",
             "-O", "b", "-v")
    _check_fused("gpu-exact-bcf", r.stderr)
    _same("gpu-exact BCF (decompressed)", _read(f"{out}/gpu.bcf", True),
          _read(f"{out}/host.bcf", True))
    r = _cli("auto", fx, f"{out}/auto.vcf", "--device", "auto", "-v",
             report=f"{out}/auto.json")
    race = _trace_lines(r.stderr, "exact engine:")
    if not race:
        raise Failed("auto: the engine race never ran (no GPU seen?)")
    for ln in race + _trace_lines(r.stderr, "fused tier:"):
        print(f"[auto] {ln}")
    _check_exact("auto", out, "auto")
    _cli("f32", fx, f"{out}/f32.vcf", "--no-exact", "--device", "gpu")
    from bs_call_tpu.utils import vcfcmp

    cmp = vcfcmp.compare(
        _read(f"{out}/f32.vcf").decode(), _read(f"{out}/host.vcf").decode()
    )
    print(f"[f32] {cmp} (needs equal >= {vcfcmp.MIN_EQUAL_FRACTION} of "
          f"rows, GL within one last-digit unit or "
          f"{vcfcmp.GL_REL_TOL:g} relative)")
    if not cmp["ok"]:
        raise Failed("f32: outside the --no-exact tolerance")
    r = _child("kernels", fx["dir"], timeout=900)
    print(r.stdout.rstrip())
    r = _run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/test_gpu.py"],
        "gpu-tests", 900, BS_CALL_TEST_GPU="1",
    )
    tail = r.stdout.strip().splitlines()[-1]
    print(f"[gpu-tests] {tail}")
    if "passed" not in tail or "skipped" in tail:
        raise Failed("gpu-tests: the gpu-marked tests did not all run")


def four_cards(out):
    fx = _fixture()
    r = _child("mesh-kernels", fx["dir"], timeout=900)
    print(r.stdout.rstrip())
    _host_runs(fx, out, bcf=False)
    r = _cli("mesh-exact-vcf", fx, f"{out}/mesh.vcf", "--device", "gpu",
             "-v", report=f"{out}/mesh.json")
    _check_fused("mesh-exact-vcf", r.stderr)
    if not any(" 4 gpu device(s)" in ln
               for ln in _trace_lines(r.stderr, "fused tier:")):
        raise Failed("mesh-exact-vcf: the 4-GPU mesh never engaged")
    _check_exact("mesh-exact", out, "mesh")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--child", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return CHILDREN[args.child[0]](*args.child[1:])
    if not os.path.isdir(os.path.join(HERE, "bs_call_tpu")):
        print("chip_smoke: run from the root of a bs_call_tpu checkout",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        info = _devices()
        if info["count"] < args.cards:
            raise Failed(
                f"--cards {args.cards}: JAX sees {info['count']} GPU(s)"
            )
        _nvidia_smi()
        out = os.path.join(HERE, ".cache", "smoke", "out")
        os.makedirs(out, exist_ok=True)
        (four_cards if args.cards == 4 else one_card)(out)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total wall {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"],
    }}))
    return 0


# ---------------------------------------------------------------------------
# child phases (each runs in its own process)


def child_devices():
    import jax

    devs = jax.devices()
    print(json.dumps({
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs), "repr": repr(devs),
    }))
    return 0


def child_fixture(d):
    from bs_call_tpu.utils.synth import make_dbsnp_index, make_wgbs_fixture

    os.makedirs(d, exist_ok=True)
    _ref, _bam, n = make_wgbs_fixture(
        d, FIXTURE["n_reads"], FIXTURE["ctg_len"], seed=FIXTURE["seed"],
        n_contigs=FIXTURE["n_contigs"],
    )
    make_dbsnp_index(
        os.path.join(d, "dbsnp.idx"),
        [f"chr{c + 1}" for c in range(FIXTURE["n_contigs"])],
        FIXTURE["ctg_len"], seed=FIXTURE["seed"],
    )
    with open(os.path.join(d, "done"), "w") as f:
        f.write(str(n))
    return 0


def _compiled(fn, *args, **static):
    """Compile `fn` for `args`, print its memory analysis, return it."""
    c = fn.lower(*args, **static).compile()
    print(f"  memory_analysis: {c.memory_analysis()}")
    return c


def _steady(c, args, n=20):
    """Host-clock times of n warm calls, dispatch included (no trace):
    prints min / median / max in ms."""
    import jax

    jax.block_until_ready(c(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(c(*args))
        ts.append(1e3 * (time.perf_counter() - t0))
    ts.sort()
    print(f"  steady ms over {n} warm calls (host clock, dispatch "
          f"included): min {ts[0]:.3f}, median {ts[n // 2]:.3f}, "
          f"max {ts[-1]:.3f}")


class _Checks:
    def __init__(self):
        self.fails = []

    def __call__(self, name, ok, detail):
        print(f"  {name}: {'ok' if ok else 'FAIL'} ({detail})")
        if not ok:
            self.fails.append(name)

    def rel(self, name, got, want, tol):
        """gt_prob: relative to the value, absolute below magnitude 1."""
        err = (np.abs(got - want) / (1 + np.abs(want))).max()
        self(name, err <= tol, f"max rel err {err:.3g} <= {tol:g}")

    def done(self, phase):
        if self.fails:
            raise SystemExit(f"{phase} failed: {self.fails}")
        return 0


def _kernel_inputs(d):
    """The fixture's first block at the kernels' real widths: the host
    pileup and aggregate, the block's read batch padded to its own r_pad
    and to 16384, the reference codes and the NumPy f64 model's output.
    Returns a dict."""
    from bs_call_tpu.config import CallerConfig
    from bs_call_tpu.io.fasta import FastaIndex, sequence_window
    from bs_call_tpu.native.pipeline import NativePipeline
    from bs_call_tpu.ops.genotype import ModelParams
    from bs_call_tpu.ops.genotype_np import call_genotypes_np
    from bs_call_tpu.ops.kernels.pileup_device import pad_read_batch

    cfg = CallerConfig().sanitize()
    p = NativePipeline(
        os.path.join(d, "in.bam"), cfg,
        np.ones(FIXTURE["n_contigs"], np.int8),
    )
    blk = p.next_block()
    reads = p.block_reads()
    p.close()
    sz = min(blk["y"] - blk["x"] + 1, N_POS - 64)
    starts, lens = reads["starts"], reads["lens"]
    n_rows = int(((starts <= sz - 1) & (starts + lens - 1 >= 0)).sum())
    r_pad = 1024
    while r_pad < n_rows:
        r_pad *= 2
    pseq = FastaIndex(os.path.join(d, "ref.fa")).load_contig("chr1")
    ref = np.zeros(N_POS, np.int32)
    ref[:sz] = sequence_window(pseq, blk["x"], sz)
    counts = np.zeros((N_POS, 8), np.int32)
    quals = np.zeros((N_POS, 8), np.int32)
    counts[:sz] = blk["agg"]["counts"][:sz]
    quals[:sz] = blk["agg"]["quals"][:sz]
    gp, gt, m, _ = call_genotypes_np(
        counts, quals, ref, cfg.under_conv, cfg.over_conv, cfg.ref_bias
    )
    print(f"n_pos {N_POS}, window {sz}, reads {n_rows}, l_cap {L_CAP}")
    return dict(
        cfg=cfg, blk=blk, sz=sz, ref=ref, counts=counts, quals=quals,
        params=ModelParams(cfg.under_conv, cfg.over_conv, cfg.ref_bias),
        padded={
            rp: pad_read_batch(reads, 0, sz - 1, rp, L_CAP)
            for rp in sorted({r_pad, 16384})
        },
        cov=counts.sum(axis=1) > 0, want_gp=gp, want_gt=gt, want_m=m,
    )


def _check_fused_out(check, k, out, tag):
    """Fused-tier outputs (gt_prob, max_gt, margin, off, quals_u8)
    against the host aggregate and the NumPy f64 model."""
    gp, gt, _m, _o, q8 = (np.asarray(a) for a in out)
    sz, cov = k["sz"], k["cov"]
    check(f"{tag} quals", np.array_equal(q8[:sz], k["quals"][:sz]),
          "exact")
    check.rel(f"{tag} gt_prob", gp[cov], k["want_gp"][cov], 1e-12)
    clear = cov & (k["want_m"] > 1e-9)
    check(f"{tag} max_gt", np.array_equal(gt[clear], k["want_gt"][clear]),
          f"{int(clear.sum())} rows with a clear winner")


def child_kernels(d):
    from bs_call_tpu.utils import configure_jax

    jax = configure_jax()
    import jax.numpy as jnp

    from bs_call_tpu.ops.genotype import call_genotypes
    from bs_call_tpu.ops.kernels.pileup_device import (
        device_pileup,
        fused_ll_f64,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernels: no GPU (found {dev.platform})")
    print(f"kernels on {dev.device_kind}:", end=" ")
    k = _kernel_inputs(d)
    cfg, blk, sz, cov = k["cfg"], k["blk"], k["sz"], k["cov"]
    check = _Checks()

    for r_pad, padded in k["padded"].items():
        # 1. pileup scatter-add against the host C++ pileup
        print(f"device_pileup, r_pad {r_pad}")
        dargs = jax.device_put(padded, dev)
        c = _compiled(device_pileup, *dargs, n_pos=N_POS,
                      min_qual=cfg.min_qual)
        c2, qs, m2 = (np.asarray(a)[:sz] for a in c(*dargs))
        check("counts2", np.array_equal(c2, blk["counts2"][:sz]), "exact")
        check("qual_sum", np.array_equal(qs, blk["qual_sum"][:sz]),
              "exact")
        small = blk["mapq2_sum"][:sz] < 2**24
        check("mapq2_sum", np.array_equal(
            m2[small], blk["mapq2_sum"][:sz][small]
        ), f"exact below 2^24 ({int((~small).sum())} rows above)")
        _steady(c, dargs)

        # 2. the fused tier (pileup + aggregation + f64 model)
        fargs = jax.device_put((*padded, k["ref"]), dev)
        print(f"fused_ll_f64, r_pad {r_pad}")
        c = _compiled(fused_ll_f64, *fargs, n_pos=N_POS,
                      min_qual=cfg.min_qual, params=k["params"])
        _check_fused_out(check, k, c(*fargs), "fused")
        _steady(c, fargs)

    # 3. the genotype model in f64 and f32 against the NumPy f64 twin
    margs = jax.device_put((k["counts"], k["quals"], k["ref"]), dev)
    for dtype, tol in ((jnp.float64, 1e-12), (jnp.float32, 1e-4)):
        name = jnp.dtype(dtype).name
        print(f"call_genotypes {name}")
        c = _compiled(call_genotypes, *margs, params=k["params"],
                      dtype=dtype)
        gp, gt, _m, _o = (np.asarray(a) for a in c(*margs))
        check.rel(f"gt_prob {name}", gp[cov], k["want_gp"][cov], tol)
        clear = cov & (k["want_m"] > (1e-9 if tol < 1e-6 else 1e-3))
        check(f"max_gt {name}",
              np.array_equal(gt[clear], k["want_gt"][clear]),
              f"{int(clear.sum())} rows with a clear winner")
        _steady(c, margs)
    return check.done("kernels")


def child_mesh_kernels(d):
    """sharded_fused_ll_f64 over a 4-GPU mesh (reads data-parallel, psum
    of the pileup) against the host pileup and the NumPy f64 model."""
    from bs_call_tpu.utils import configure_jax

    jax = configure_jax()
    from jax.sharding import Mesh

    from bs_call_tpu.ops.kernels.pileup_device import sharded_fused_ll_f64
    from bs_call_tpu.parallel.sharding import shard_positions

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < 4:
        raise SystemExit(f"mesh-kernels: needs 4 GPUs (found {devs})")
    print(f"mesh kernels on 4 x {devs[0].device_kind}:", end=" ")
    k = _kernel_inputs(d)
    mesh = Mesh(np.array(devs[:4]), ("pos",))
    fn = sharded_fused_ll_f64(mesh, k["params"], N_POS, k["cfg"].min_qual)
    check = _Checks()
    for r_pad, padded in k["padded"].items():
        print(f"sharded_fused_ll_f64, 4 devices, r_pad {r_pad}")
        args = shard_positions(mesh, *padded, k["ref"])
        c = _compiled(fn, *args)
        _check_fused_out(check, k, c(*args), "mesh fused")
        _steady(c, args)
    return check.done("mesh-kernels")


CHILDREN = {
    "devices": child_devices,
    "fixture": child_fixture,
    "kernels": child_kernels,
    "mesh-kernels": child_mesh_kernels,
}


if __name__ == "__main__":
    sys.exit(main())
