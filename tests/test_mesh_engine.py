"""Production mesh-engine tests: the position-sharded engine path must be
bitwise identical to the single-device engines at every tier, and the full
pipeline through the mesh must reproduce the golden outputs byte-for-byte
(VERDICT r1 item 1: multi-chip as the real engine, not a demo)."""

import io
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.ops.genotype import ModelParams, call_genotypes
from bs_call_tpu.parallel.sharding import (
    make_mesh,
    shard_positions,
    sharded_call_genotypes,
    usable_device_count,
)
from bs_call_tpu.pipeline.engine import CallEngine


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    n = 1 << 12
    counts = rng.integers(0, 30, size=(n, 8)).astype(np.int32)
    counts[rng.random((n, 8)) < 0.5] = 0
    quals = np.where(
        counts > 0, rng.integers(1, 44, size=(n, 8)), 0
    ).astype(np.int32)
    ref = rng.integers(0, 5, size=n).astype(np.int32)
    return counts, quals, ref


def test_usable_device_count():
    assert usable_device_count(8, 1 << 15) == 8
    assert usable_device_count(6, 1 << 15) == 4
    assert usable_device_count(1, 1 << 15) == 1
    assert usable_device_count(8, 12) == 4  # 12 % 8 != 0, 12 % 4 == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_kernel_bitwise(batch, dtype):
    counts, quals, ref = batch
    params = ModelParams()
    dt = jnp.float64 if dtype == "float64" else jnp.float32
    mesh = make_mesh(8)
    fn = sharded_call_genotypes(mesh, params, dt)
    got = fn(*shard_positions(mesh, counts, quals, ref))
    want = call_genotypes(counts, quals, ref, params, dtype=dt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_engine_mesh_vs_single(batch):
    """CallEngine with the mesh enabled (8 virtual devices) must produce
    bitwise-identical calls to the mesh-disabled engine, exact mode."""
    counts, quals, ref = batch
    cfg_m = CallerConfig(batch_positions=1 << 10)
    cfg_s = CallerConfig(batch_positions=1 << 10, use_mesh=False)
    em, es = CallEngine(cfg_m), CallEngine(cfg_s)
    rm = em._call_batch(counts, quals, ref)
    rs = es._call_batch(counts, quals, ref)
    assert em._sharded, "mesh kernel was not engaged"
    assert any(v is not None for v in em._sharded.values())
    for a, b in zip(rm, rs):
        np.testing.assert_array_equal(a, b)


def test_engine_column_f64_through_mesh(batch):
    """device=gpu exact mode's column engine (the f64 kernel on the
    handed device) shards over the 8-device mesh: bitwise equal to the
    single-device engine, and equal to the host f64 engine's calls."""
    counts, quals, ref = batch
    cpu = jax.devices("cpu")[0]
    em = CallEngine(CallerConfig(device="gpu", batch_positions=1 << 10),
                    device=cpu)
    es = CallEngine(CallerConfig(device="gpu", batch_positions=1 << 10,
                                 use_mesh=False), device=cpu)
    rm = em._call_batch(counts, quals, ref)
    rs = es._call_batch(counts, quals, ref)
    assert em._sharded.get(("f64", "cpu")) is not None
    assert es._sharded.get(("f64", "cpu")) is None
    for a, b in zip(rm, rs):
        np.testing.assert_array_equal(a, b)
    host = CallEngine(CallerConfig(device="numpy"))._call_batch(
        counts, quals, ref
    )
    np.testing.assert_array_equal(rm[1], host[1])
    np.testing.assert_allclose(rm[0], host[0], rtol=1e-12, atol=1e-12)


def test_golden_through_mesh():
    """Full pipeline over the 8-device mesh == committed golden bytes."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from make_golden import GOLDEN_DIR, run

    if not os.path.exists(os.path.join(GOLDEN_DIR, "golden.vcf")):
        pytest.skip("golden files not generated")
    assert len(jax.devices()) == 8
    with tempfile.TemporaryDirectory() as tmp:
        vcf, report = run(tmp)  # default config: mesh engages on 8 devs
    with open(os.path.join(GOLDEN_DIR, "golden.vcf")) as f:
        assert vcf == f.read()
    with open(os.path.join(GOLDEN_DIR, "golden_report.json")) as f:
        assert report == f.read()
