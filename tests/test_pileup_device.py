"""Device pileup kernel parity vs the host scatter-add (ops/pileup.py):
counts and f32 qual sums bit-exact, the fused steps' genotype outputs
equal to the unfused chain, and the sharded fused f64 tier bitwise equal
to the single-device one."""

import numpy as np
import pytest

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.io.bam import BamReader
from bs_call_tpu.io.fasta import FastaIndex
from bs_call_tpu.ops.kernels.pileup_device import (
    device_pileup,
    fused_pileup_call,
    pack_reads,
)
from bs_call_tpu.ops.pileup import build_pileup
from bs_call_tpu.pipeline.blocks import read_blocks
from bs_call_tpu.pipeline.contigs import reconcile_contigs
from bs_call_tpu.pipeline.template import process_template

from test_native_pipeline import random_bam


def blocks_of(ref, bam, cfg):
    reader = BamReader(bam)
    fasta = FastaIndex(ref)
    table = reconcile_contigs(fasta, reader.header, make_stats=False)
    for block in read_blocks(iter(reader), table, cfg, stats=None):
        first = block.align_list[0]
        x = first.forward_position or first.reverse_position
        x = x - 2 if x > 2 else 1
        for al in block.align_list:
            process_template(
                al, cfg.left_trim, cfg.right_trim, stats=None,
                min_qual=cfg.min_qual,
            )
        yield block, x, block.y


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_device_pileup_matches_host(tmp_path, seed):
    ref, bam = random_bam(tmp_path, n_pairs=250, seed=seed)
    cfg = CallerConfig(left_trim=(1, 0), right_trim=(0, 1))
    n_blocks = 0
    for block, x, y in blocks_of(ref, bam, cfg):
        sz = y - x + 1
        want_c2, want_qs, want_m2 = build_pileup(
            block.align_list, x, y, cfg.min_qual
        )
        rd, starts, ori, strand, mapq = pack_reads(block.align_list, x)
        c2, qs, m2 = device_pileup(
            rd, starts, ori, strand, mapq, sz, cfg.min_qual
        )
        np.testing.assert_array_equal(np.asarray(c2), want_c2)
        # f32 sums accumulate in the same (read, base) order
        np.testing.assert_array_equal(np.asarray(qs), want_qs)
        np.testing.assert_array_equal(np.asarray(m2), want_m2)
        n_blocks += 1
    assert n_blocks > 0


def test_fused_call_matches_unfused(tmp_path):
    import jax.numpy as jnp

    from bs_call_tpu.io.fasta import sequence_window
    from bs_call_tpu.ops.genotype import ModelParams, call_genotypes

    ref, bam = random_bam(tmp_path, n_pairs=200, seed=3)
    cfg = CallerConfig()
    fasta = FastaIndex(ref)
    pseq = fasta.load_contig("chr1")
    params = ModelParams()
    checked = 0
    for block, x, y in blocks_of(ref, bam, cfg):
        sz = y - x + 1
        rd, starts, ori, strand, mapq = pack_reads(block.align_list, x)
        refw = sequence_window(pseq, x, sz).astype(np.int32)
        gp, mg, mr, off, c2, qs, m2 = fused_pileup_call(
            rd, starts, ori, strand, mapq, refw, sz, cfg.min_qual,
            params, dtype=jnp.float32,
        )
        # unfused: host pileup -> aggregate quals (f32) -> device call
        want_c2, want_qs, _ = build_pileup(
            block.align_list, x, y, cfg.min_qual
        )
        counts = want_c2.sum(axis=1)
        nn = counts.astype(np.float32)
        avg = want_qs / np.where(nn > 0, nn, np.float32(1))
        quals = np.where(
            counts > 0, np.floor(np.float32(0.5) + avg), 0
        ).astype(np.int32)
        wgp, wmg, wmr, woff = call_genotypes(
            counts, quals, refw, params, dtype=jnp.float32
        )
        np.testing.assert_array_equal(np.asarray(c2), want_c2)
        np.testing.assert_array_equal(np.asarray(mg), np.asarray(wmg))
        np.testing.assert_array_equal(np.asarray(gp), np.asarray(wgp))
        checked += 1
    assert checked > 0


def _read_batch(rng, n_pos, R, L):
    q = rng.integers(0, 44, size=(R, L)).astype(np.uint8)
    rd = rng.integers(0, 4, size=(R, L)).astype(np.uint8) | (q << 2)
    return (
        rd,
        rng.integers(-L, n_pos, size=R).astype(np.int32),
        rng.integers(0, 2, size=R).astype(np.int32),
        rng.integers(0, 3, size=R).astype(np.int32),
        rng.integers(0, 61, size=R).astype(np.int32),
    )


@pytest.mark.parametrize("seed", [2, 3])
def test_fused_f64_matches_unfused_chain(seed):
    """fused_ll_f64 == device_pileup -> f32 aggregation -> f64 model."""
    import jax.numpy as jnp

    from bs_call_tpu.ops.genotype import ModelParams, call_genotypes
    from bs_call_tpu.ops.kernels.pileup_device import fused_ll_f64
    from bs_call_tpu.ops.postprocess import aggregate_pileup

    rng = np.random.default_rng(seed)
    n_pos = 1024
    batch = _read_batch(rng, n_pos, 512, 64)
    ref = rng.integers(0, 5, n_pos).astype(np.int32)
    params = ModelParams()
    got = fused_ll_f64(*batch, ref, n_pos=n_pos, min_qual=13,
                       params=params)
    c2, qs, m2 = device_pileup(*batch, n_pos=n_pos, min_qual=13)
    agg = aggregate_pileup(np.asarray(c2), np.asarray(qs), np.asarray(m2))
    want = call_genotypes(agg["counts"].astype(np.int32), agg["quals"],
                          ref, params, dtype=jnp.float64)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(got[4]), agg["quals"])
    assert np.asarray(got[0]).dtype == np.float64


def test_sharded_fused_f64_bitwise_equal_single_device():
    """The 8-virtual-device mesh (reads data-parallel, one psum) gives
    the single-device fused f64 tier's outputs bit for bit."""
    import jax

    from bs_call_tpu.ops.genotype import ModelParams
    from bs_call_tpu.ops.kernels.pileup_device import (
        fused_ll_f64,
        sharded_fused_ll_f64,
    )
    from bs_call_tpu.parallel.sharding import make_mesh, shard_positions

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(9)
    n_pos = 1088  # the engine's padded width at batch 1024
    args = (*_read_batch(rng, n_pos, 1024, 96),
            rng.integers(0, 5, n_pos).astype(np.int32))
    params = ModelParams()
    mesh = make_mesh(8)
    got = sharded_fused_ll_f64(mesh, params, n_pos, 13)(
        *shard_positions(mesh, *args)
    )
    want = fused_ll_f64(*args, n_pos=n_pos, min_qual=13, params=params)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError):
        sharded_fused_ll_f64(mesh, params, n_pos + 4, 13)
