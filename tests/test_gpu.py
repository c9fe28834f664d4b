"""Device tier on a real GPU: the same contracts the CPU-device tests
check, on the card. Marked `gpu`; the `gpu` fixture skips them where JAX
sees no GPU, and chip_smoke.py runs them on the card."""

import io

import numpy as np
import pytest

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.native import load
from bs_call_tpu.pipeline.runner import run_caller

from test_native_pipeline import random_bam

pytestmark = pytest.mark.gpu


def _vcf(bam, ref, device, dev=None, **kw):
    cfg = CallerConfig(
        input_file=str(bam), reference_file=str(ref), benchmark_mode=True,
        device=device, all_positions=True, batch_positions=1 << 12, **kw,
    )
    buf = io.BytesIO()
    run_caller(cfg, out_fileobj=buf, device=dev)
    return buf.getvalue()


@pytest.mark.parametrize("seed", [3, 4])
def test_fused_tier_on_gpu_matches_host(tmp_path, gpu, seed):
    if load() is None:
        pytest.skip("native toolchain unavailable")
    ref, bam = random_bam(tmp_path, n_pairs=1500, seed=seed)
    assert _vcf(bam, ref, "gpu", gpu) == _vcf(bam, ref, "cpu")


def test_device_pileup_on_gpu_matches_cpu(gpu):
    import jax

    from bs_call_tpu.ops.kernels.pileup_device import device_pileup

    rng = np.random.default_rng(5)
    n_pos, R, L = 4096, 2048, 150
    base = rng.integers(0, 4, (R, L)).astype(np.uint8)
    qual = rng.integers(0, 44, (R, L)).astype(np.uint8)
    args = (
        base | (qual << 2),
        rng.integers(-L, n_pos, R).astype(np.int32),
        rng.integers(0, 2, R).astype(np.int32),
        rng.integers(0, 3, R).astype(np.int32),
        rng.integers(0, 61, R).astype(np.int32),
    )
    cpu = jax.devices("cpu")[0]
    got = device_pileup(*jax.device_put(args, gpu), n_pos=n_pos,
                        min_qual=13)
    want = device_pileup(*jax.device_put(args, cpu), n_pos=n_pos,
                         min_qual=13)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_f64_model_on_gpu_matches_numpy(gpu):
    import jax
    import jax.numpy as jnp

    from bs_call_tpu.ops.genotype import ModelParams, call_genotypes
    from bs_call_tpu.ops.genotype_np import call_genotypes_np

    rng = np.random.default_rng(9)
    n = 1 << 14
    counts = rng.integers(0, 40, (n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(counts > 0, rng.integers(1, 44, (n, 8)), 0).astype(
        np.int32
    )
    ref = rng.integers(0, 5, n).astype(np.int32)
    gp, gt, _m, _o = call_genotypes(
        *jax.device_put((counts, quals, ref), gpu), ModelParams(),
        dtype=jnp.float64,
    )
    wgp, wgt, wm, _ = call_genotypes_np(counts, quals, ref, 0.01, 0.05, 2.0)
    err = np.abs(np.asarray(gp) - wgp) / (1 + np.abs(wgp))
    assert err.max() <= 1e-12
    clear = wm > 1e-9
    np.testing.assert_array_equal(np.asarray(gt)[clear], wgt[clear])
