"""Fused device tier (reads cross H2D; pileup + aggregation + f64 model
in one program), driven on a CPU device handed to the engine: byte
identity vs the host engines, mesh engagement on the 8-virtual-device
backend, and the quals-mismatch rescue contract."""

import io
import tempfile
import pathlib

import jax
import numpy as np
import pytest

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.native import load
from bs_call_tpu.pipeline.engine import CallEngine
from bs_call_tpu.pipeline.runner import run_caller

from test_native_pipeline import random_bam

pytestmark = pytest.mark.skipif(
    load() is None, reason="native toolchain unavailable"
)

CPU = jax.devices("cpu")[0]


@pytest.fixture()
def spy_engine(monkeypatch):
    """Count fused-tier engagements/fallbacks across a run."""
    calls = {"fused": 0, "fallback": 0, "mesh": 0}
    orig_call = CallEngine._call_fused
    orig_fn = CallEngine._fused_fn

    def spy_call(self, *a, **k):
        r = orig_call(self, *a, **k)
        calls["fused" if r is not None else "fallback"] += 1
        return r

    def spy_fn(self, *a, **k):
        mesh, fn = orig_fn(self, *a, **k)
        if mesh is not None:
            calls["mesh"] += 1
        return mesh, fn

    monkeypatch.setattr(CallEngine, "_call_fused", spy_call)
    monkeypatch.setattr(CallEngine, "_fused_fn", spy_fn)
    return calls


def _run(bam, ref, device, **kw):
    """VCF bytes; device="gpu" runs the device tier on the CPU device."""
    kw.setdefault("batch_positions", 1 << 12)
    cfg = CallerConfig(
        input_file=str(bam), reference_file=str(ref),
        benchmark_mode=True, device=device, all_positions=True, **kw,
    )
    buf = io.BytesIO()
    run_caller(cfg, out_fileobj=buf,
               device=CPU if device == "gpu" else None)
    return buf.getvalue()


def _first_block(bam, cfg):
    from bs_call_tpu.native.pipeline import NativePipeline

    p = NativePipeline(str(bam), cfg, np.ones(1, np.int8))
    blk = p.next_block()
    reads = p.block_reads()
    p.close()
    return blk, reads


@pytest.mark.parametrize("seed", [3, 11])
def test_fused_mesh_byte_identity(tmp_path, spy_engine, seed):
    """device=gpu (forced fused) over the 8-device mesh must reproduce
    the numpy engine's bytes exactly, with zero fused fallbacks."""
    ref, bam = random_bam(tmp_path, n_pairs=1500, seed=seed)
    want = _run(bam, ref, "numpy")
    got = _run(bam, ref, "gpu")
    assert got == want
    assert spy_engine["fused"] > 0 and spy_engine["fallback"] == 0
    # the 8-virtual-device backend must engage the sharded fused kernel
    assert spy_engine["mesh"] > 0


def test_fused_partial_staging_identity(tmp_path, spy_engine):
    """Small batch_positions force partial-range staging (negative
    starts in the read export); fused output must stay byte-identical."""
    ref, bam = random_bam(tmp_path, n_pairs=2500, seed=7)
    want = _run(bam, ref, "numpy", batch_positions=512)
    got = _run(bam, ref, "gpu", batch_positions=512)
    assert got == want
    assert spy_engine["fused"] > 0 and spy_engine["fallback"] == 0


def test_quals_mismatch_rescues_to_oracle(tmp_path):
    """A position where the device aggregate disagrees with the host
    aggregate must be recomputed from HOST inputs via the oracle (the
    f32-boundary safety net): perturb the host quals and check the
    fused result equals the host engines on the perturbed values."""
    ref, bam = random_bam(tmp_path, n_pairs=400, seed=5)
    cfg = CallerConfig(device="gpu", batch_positions=1 << 12)
    blk, reads = _first_block(bam, cfg)
    sz = blk["y"] - blk["x"] + 1
    agg = blk["agg"]
    covered = np.nonzero(agg["n"] > 0)[0]
    # perturb one covered position's host quals
    j = covered[len(covered) // 2]
    cat = int(np.argmax(agg["counts"][j]))
    agg["quals"][j, cat] += 1
    rng = np.random.default_rng(0)
    ref_codes = rng.integers(0, 5, sz).astype(np.int32)

    eng = CallEngine(cfg, device=CPU)
    res = eng._call_fused(reads, 0, sz - 1, ref_codes, agg, covered)
    assert res is not None and res[4] == 1  # one row left to the oracle
    gt_prob, max_gt, margin, off = eng._finish_exact(
        *res[:4],
        agg["counts"][covered].astype(np.int32),
        agg["quals"][covered],
        ref_codes[covered],
    )
    # ground truth: the oracle on the (perturbed) host inputs
    from bs_call_tpu.ops import oracle

    jj = int(np.nonzero(covered == j)[0][0])
    want_prob, want_gt = oracle.calc_gt_prob(
        agg["counts"][j], agg["quals"][j], int(ref_codes[j]),
        cfg.under_conv, cfg.over_conv, cfg.ref_bias,
    )
    assert max_gt[jj] == want_gt
    np.testing.assert_allclose(gt_prob[jj], want_prob, rtol=0, atol=0)


def test_systematic_divergence_raises(tmp_path):
    """Device quals that differ from the host aggregate on more than 1%
    of a chunk's rows are a device fault: the fused tier raises instead
    of handing the chunk to another engine."""
    ref, bam = random_bam(tmp_path, n_pairs=400, seed=5)
    cfg = CallerConfig(device="gpu", batch_positions=1 << 12)
    blk, reads = _first_block(bam, cfg)
    sz = blk["y"] - blk["x"] + 1
    agg = blk["agg"]
    covered = np.nonzero(agg["n"] > 0)[0]
    assert len(covered) > 100
    agg["quals"][covered, :] += 1
    eng = CallEngine(cfg, device=CPU)
    with pytest.raises(RuntimeError, match="device quals differ"):
        eng._call_fused(reads, 0, sz - 1, np.ones(sz, np.int32), agg,
                        covered)


def test_fused_counters(tmp_path):
    """-v counters: a forced device run counts the chunks the fused tier
    carried, none declined and no rescued row on a clean run."""
    from bs_call_tpu.utils.trace import Tracer

    ref, bam = random_bam(tmp_path, n_pairs=1500, seed=13)
    cfg = CallerConfig(
        input_file=str(bam), reference_file=str(ref), benchmark_mode=True,
        device="gpu", batch_positions=1 << 12, use_mesh=False,
    )
    tracer = Tracer()
    run_caller(cfg, out_fileobj=io.BytesIO(), tracer=tracer, device=CPU)
    assert tracer.counts["fused_chunks"] > 0
    assert tracer.counts["fused_rescued"] == 0
    assert "fused_declined" not in tracer.counts


def test_fused_declines_oversize_reads(tmp_path):
    """Reads longer than the fused L cap must fall back (None), not
    truncate; the engine counts the declined chunk."""
    from bs_call_tpu.utils.trace import Tracer

    ref, bam = random_bam(tmp_path, n_pairs=50, seed=1)
    cfg = CallerConfig(device="gpu", batch_positions=1 << 12)
    blk, reads = _first_block(bam, cfg)
    sz = blk["y"] - blk["x"] + 1
    covered = np.nonzero(blk["agg"]["n"] > 0)[0]
    wide = {
        **reads,
        "rd": np.zeros((len(reads["starts"]), 4096), np.uint8),
    }
    wide["rd"][:, : reads["rd"].shape[1]] = reads["rd"]
    eng = CallEngine(cfg, device=CPU)
    ref_codes = np.ones(sz, np.int32)
    assert (
        eng._call_fused(wide, 0, sz - 1, ref_codes, blk["agg"], covered)
        is None
    )
    eng.tracer = Tracer()
    eng.call_block_soa(blk["counts2"], blk["qual_sum"], blk["mapq2_sum"],
                       ref_codes, agg=blk["agg"], reads=(wide, 0))
    assert eng.tracer.counts["fused_declined"] == 1
    assert "fused_chunks" not in eng.tracer.counts


def test_auto_gate_waits_for_race(tmp_path):
    """device=auto with a device runs f64 until RACE_AFTER positions,
    exporting reads meanwhile; the race's verdict then decides."""
    cfg = CallerConfig(device="auto", batch_positions=1 << 12)
    eng = CallEngine(cfg, device=CPU)
    assert not eng._fused_gate(None, 0, 0, None, None, np.arange(10))
    assert eng._exact_engine is None and eng.wants_reads()
    eng._exact_engine = "fused"
    assert eng._fused_gate(None, 0, 0, None, None, np.arange(10))
    assert eng.wants_reads()
    eng._exact_engine = "f64"
    assert not eng.wants_reads()


def test_auto_race_picks_an_engine_and_keeps_bytes(tmp_path, monkeypatch):
    """With the race threshold lowered, device=auto races the fused tier
    against the host f64 engine on a real chunk, traces its verdict, and
    the output bytes equal the host run's either way."""
    ref, bam = random_bam(tmp_path, n_pairs=1500, seed=5)
    want = _run(bam, ref, "cpu")
    monkeypatch.setattr(CallEngine, "RACE_AFTER", 1)
    seen = []
    monkeypatch.setattr(
        CallEngine, "_trace_decision", lambda self, m: seen.append(m)
    )
    cfg = CallerConfig(
        input_file=str(bam), reference_file=str(ref), benchmark_mode=True,
        device="auto", all_positions=True, batch_positions=1 << 12,
    )
    buf = io.BytesIO()
    run_caller(cfg, out_fileobj=buf, device=CPU)
    assert buf.getvalue() == want
    assert any(m.startswith("exact engine: ") for m in seen)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fused_matches_host_native(tmp_path, spy_engine, seed):
    """The single-device fused f64 tier against the host native f64
    engine (--device cpu): byte-identical VCFs."""
    ref, bam = random_bam(tmp_path, n_pairs=1200, seed=seed)
    want = _run(bam, ref, "cpu")
    got = _run(bam, ref, "gpu", use_mesh=False)
    assert got == want
    assert spy_engine["fused"] > 0 and spy_engine["mesh"] == 0


@pytest.mark.parametrize("mesh", [False, True])
def test_cpu_device_engine_matches_host(tmp_path, spy_engine, mesh):
    """An engine handed a CPU device, exact mode, single device and over
    the 8-device mesh: VCF AND report bytes equal to the host run's."""
    from bs_call_tpu.stats.collect import BsStats
    from bs_call_tpu.stats.report import write_report

    def run_with_report(device, **kw):
        cfg = CallerConfig(
            input_file=str(bam), reference_file=str(ref),
            benchmark_mode=True, device=device, all_positions=True,
            report_file="x.json", batch_positions=1 << 12, **kw,
        )
        buf = io.BytesIO()
        stats, table = run_caller(
            cfg, out_fileobj=buf, stats=BsStats(),
            device=CPU if device == "gpu" else None,
        )
        rep = io.StringIO()
        write_report(rep, cfg, stats, table)
        return buf.getvalue(), rep.getvalue()

    ref, bam = random_bam(tmp_path, n_pairs=1500, seed=31)
    want = run_with_report("cpu")
    assert run_with_report("gpu", use_mesh=mesh) == want
    assert spy_engine["fused"] > 0 and (spy_engine["mesh"] > 0) == mesh


def test_no_exact_cpu_device_within_tolerance(tmp_path):
    """--no-exact on a CPU device against --device cpu, within
    utils/vcfcmp.py's stated f32 tolerance."""
    from bs_call_tpu.utils import vcfcmp

    ref, bam = random_bam(tmp_path, n_pairs=3000, seed=41)
    want = _run(bam, ref, "cpu").decode()
    got = _run(bam, ref, "gpu", exact=False).decode()
    cmp = vcfcmp.compare(got, want)
    assert cmp["ok"], cmp


def test_fused_reference_with_N(tmp_path):
    """An N-holed reference (the emitter truncates its context after an
    N, print_vcf.c:563-580, while the device sees raw codes): fused
    output stays byte-identical."""
    import io

    import numpy as np

    from bs_call_tpu.io.bam import BamHeader, BamWriter

    rng = np.random.default_rng(3)
    L = 4000
    seq = rng.choice(list("ACGT"), L)
    # pepper Ns so many covered sites sit 1-2 positions after one
    for p in range(50, L - 3, 37):
        seq[p] = "N"
    ref = tmp_path / "n.fa"
    ref.write_text(
        ">chr1\n" + "\n".join(
            "".join(seq[i:i + 60]) for i in range(0, L, 60)
        ) + "\n"
    )
    hdr = BamHeader(
        text=f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:{L}\n",
        ref_names=["chr1"], ref_lens=[L],
    )
    bam = tmp_path / "n.bam"
    w = BamWriter(str(bam), hdr)
    bases = "ACGT"
    k = 0
    for pos in range(0, L - 80, 3):
        rl = 60
        rseq = ["A" if b == "N" else b for b in seq[pos:pos + rl]]
        for i in np.nonzero(rng.random(rl) < 0.03)[0]:
            rseq[i] = bases[int(rng.integers(0, 4))]
        q = rng.integers(20, 44, rl).astype(np.uint8)
        w.write(f"r{k:05d}", 0, 0, pos, 57, [(rl, 0)], -1, -1, 0,
                "".join(rseq), q)
        k += 1
    w.close()
    want = _run(bam, ref, "numpy")
    got = _run(bam, ref, "gpu", use_mesh=False)
    assert got == want
