"""Unit tests: vectorized JAX genotype model vs the scalar float64 oracle.

The oracle (bs_call_tpu.ops.oracle) transcribes genotype_model.c:44-246
directly using libm (math.log/exp) like the C binary; the JAX kernel uses
XLA's transcendentals, which differ in the last ulp. Positions whose top-2
log-likelihood margin is below a tolerance are therefore excluded here and
handled by the runtime rescue path, which recomputes them with the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bs_call_tpu.ops import oracle
from bs_call_tpu.ops.genotype import ModelParams, call_genotypes

PARAMS = ModelParams(under_conv=0.01, over_conv=0.05, ref_bias=2.0)


def random_cases(rng, n, max_count=40):
    counts = rng.integers(0, max_count, size=(n, 8)).astype(np.int32)
    # make some categories zero to hit the n==0 guard paths
    mask = rng.random((n, 8)) < 0.45
    counts[mask] = 0
    quals = np.where(
        counts > 0, rng.integers(1, 44, size=(n, 8)), 0
    ).astype(np.int32)
    ref = rng.integers(0, 5, size=n).astype(np.int32)
    return counts, quals, ref


def oracle_batch(counts, quals, ref):
    probs = np.zeros((len(ref), 10))
    gts = np.zeros(len(ref), dtype=np.int32)
    for i in range(len(ref)):
        probs[i], gts[i] = oracle.calc_gt_prob(
            counts[i], quals[i], int(ref[i]), 0.01, 0.05, 2.0
        )
    return probs, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_oracle_f64(seed):
    rng = np.random.default_rng(seed)
    counts, quals, ref = random_cases(rng, 500)
    gt_prob, max_gt, margin, _ = call_genotypes(
        counts, quals, ref, PARAMS, dtype=jnp.float64
    )
    gt_prob, max_gt, margin = map(np.asarray, (gt_prob, max_gt, margin))
    want_prob, want_gt = oracle_batch(counts, quals, ref)
    clear = margin > 1e-9  # rescue path handles the rest at runtime
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(max_gt[clear], want_gt[clear])
    np.testing.assert_allclose(
        gt_prob[clear], want_prob[clear], rtol=1e-10, atol=1e-10
    )


def test_matches_oracle_f32_tolerance():
    rng = np.random.default_rng(42)
    counts, quals, ref = random_cases(rng, 2000)
    gt_prob, max_gt, margin, _ = call_genotypes(
        counts, quals, ref, PARAMS, dtype=jnp.float32
    )
    gt_prob, max_gt, margin = map(np.asarray, (gt_prob, max_gt, margin))
    want_prob, want_gt = oracle_batch(counts, quals, ref)
    # float32: absolute ll error scales with magnitude; rescue threshold
    clear = margin > 1e-2 * np.maximum(1.0, np.abs(gt_prob).max(axis=1))
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(max_gt[clear], want_gt[clear])
    np.testing.assert_allclose(
        gt_prob[clear], want_prob[clear], rtol=5e-3, atol=5e-3
    )


def test_empty_position():
    counts = np.zeros((1, 8), dtype=np.int32)
    quals = np.zeros((1, 8), dtype=np.int32)
    ref = np.array([2], dtype=np.int32)
    gt_prob, max_gt, _, _ = call_genotypes(counts, quals, ref, PARAMS, dtype=jnp.float64)
    want_prob, want_gt = oracle.calc_gt_prob(counts[0], quals[0], 2, 0.01, 0.05, 2.0)
    assert int(max_gt[0]) == want_gt == 4  # CC favored by ref prior
    np.testing.assert_allclose(np.asarray(gt_prob)[0], want_prob, rtol=1e-12)


def test_high_depth_homozygote():
    counts = np.array([[0, 100, 0, 0, 0, 0, 0, 0]], dtype=np.int32)
    quals = np.array([[0, 40, 0, 0, 0, 0, 0, 0]], dtype=np.int32)
    ref = np.array([2], dtype=np.int32)
    _, max_gt, _, _ = call_genotypes(counts, quals, ref, PARAMS, dtype=jnp.float64)
    assert int(max_gt[0]) == 4  # CC


def test_informative_counts_drive_meth_genotypes():
    # C-informative + T-informative mixture on ref C: CC vs CT decision uses Z
    counts = np.array([[0, 0, 0, 0, 0, 10, 0, 3]], dtype=np.int32)
    quals = np.array([[0, 0, 0, 0, 0, 35, 0, 35]], dtype=np.int32)
    ref = np.array([2], dtype=np.int32)
    gt_prob, max_gt, _, _ = call_genotypes(counts, quals, ref, PARAMS, dtype=jnp.float64)
    want_prob, want_gt = oracle.calc_gt_prob(counts[0], quals[0], 2, 0.01, 0.05, 2.0)
    assert int(max_gt[0]) == want_gt
    np.testing.assert_allclose(np.asarray(gt_prob)[0], want_prob, rtol=1e-10)


def test_z_clamping_edges():
    # extreme imbalance drives sinm outside [-1, 1] (genotype_model.c:29-40)
    for c5, c7 in [(50, 0), (0, 50), (50, 1), (1, 50)]:
        counts = np.zeros((1, 8), dtype=np.int32)
        counts[0, 5] = c5
        counts[0, 7] = c7
        quals = np.where(counts > 0, 30, 0).astype(np.int32)
        ref = np.array([2], dtype=np.int32)
        gt_prob, max_gt, margin, _ = call_genotypes(
            counts, quals, ref, PARAMS, dtype=jnp.float64
        )
        want_prob, want_gt = oracle.calc_gt_prob(
            counts[0], quals[0], 2, 0.01, 0.05, 2.0
        )
        if float(margin[0]) > 1e-9:
            assert int(max_gt[0]) == want_gt
            np.testing.assert_allclose(
                np.asarray(gt_prob)[0], want_prob, rtol=1e-10, atol=1e-10
            )


def _edge_batch():
    """Adversarial structured batch hitting every Z-clamp boundary
    (genotype_model.c:28-41) and the qual extremes (1 and MAX_QUAL=43)
    across all four informative categories, on every reference base —
    the drift guard for the four model implementations (VERDICT r1
    item 10)."""
    cases = []
    combos = [
        (5, 7), (7, 5), (6, 4), (4, 6),  # each Z family, both orders
    ]
    for ca, cb in combos:
        for na, nb in [
            (1, 0), (0, 1), (200, 0), (0, 200), (200, 1), (1, 200),
            (3, 3), (1000, 999),
        ]:
            for qa, qb in [(1, 1), (43, 43), (1, 43), (43, 1), (20, 43)]:
                c = np.zeros(8, np.int32)
                q = np.zeros(8, np.int32)
                c[ca], c[cb] = na, nb
                q[ca] = qa if na else 0
                q[cb] = qb if nb else 0
                cases.append((c, q))
    # mixed informative + non-informative at the extremes
    for qq in (1, 43):
        c = np.array([5, 0, 0, 5, 7, 9, 2, 4], np.int32)
        q = np.where(c > 0, qq, 0).astype(np.int32)
        cases.append((c, q))
        c = np.full(8, 500, np.int32)
        q = np.where(c > 0, qq, 0).astype(np.int32)
        cases.append((c, q))
    counts = np.stack([c for c, _ in cases])
    quals = np.stack([q for _, q in cases])
    # every ref base for every case
    counts = np.repeat(counts, 5, axis=0)
    quals = np.repeat(quals, 5, axis=0)
    ref = np.tile(np.arange(5, dtype=np.int32), len(cases))
    return counts, quals, ref


def test_adversarial_edges_all_tiers():
    from bs_call_tpu.ops.genotype_native import native_model
    from bs_call_tpu.ops.genotype_np import call_genotypes_np

    counts, quals, ref = _edge_batch()
    want_prob, want_gt = oracle_batch(counts, quals, ref)

    # tier 1: f64 XLA kernel (the GPU exact engine)
    gp, mg, margin, _ = call_genotypes(
        counts, quals, ref, PARAMS, dtype=jnp.float64
    )
    gp, mg, margin = map(np.asarray, (gp, mg, margin))
    clear = margin > 1e-9
    np.testing.assert_array_equal(mg[clear], want_gt[clear])
    np.testing.assert_allclose(
        gp[clear], want_prob[clear], rtol=1e-9, atol=1e-9
    )

    # tier 2: NumPy f64
    gp2, mg2, margin2, _ = call_genotypes_np(
        counts, quals, ref, 0.01, 0.05, 2.0
    )
    clear2 = margin2 > 1e-9
    np.testing.assert_array_equal(mg2[clear2], want_gt[clear2])
    np.testing.assert_allclose(
        gp2[clear2], want_prob[clear2], rtol=1e-9, atol=1e-9
    )

    # tier 3: native C++ f64 (the host exact engine)
    m = native_model(0.01, 0.05, 2.0)
    if m is None:
        pytest.skip("native toolchain unavailable")
    gp3, mg3, margin3, _ = m.call(counts, quals, ref)
    clear3 = (margin3 > 1e-9) & clear2
    np.testing.assert_array_equal(mg3[clear3], want_gt[clear3])
    assert np.abs(gp3 - gp2).max() < 1e-8
