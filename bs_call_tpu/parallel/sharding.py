"""Multi-chip sharding of the calling step.

Positions are data-parallel over a 1-D device mesh ("pos" axis): each chip
calls genotypes for a contiguous slab of pileup columns. Two collectives
tie the slabs together, mirroring the reference's only cross-position
couplings (SURVEY §5):

  - a 2-position halo exchange (ppermute) of called-genotype codes so the
    CpG-status stencil (print_vcf.c:231-266) is correct at slab borders;
  - a psum merge of the per-shard stats histograms (the bs_stats analogue).

The same step function runs on a virtual CPU mesh in tests and on several
GPUs in production.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bs_call_tpu.ops.genotype import ModelParams, genotype_log_likelihoods
from bs_call_tpu.constants import LOG10


def make_mesh(n_devices: int = None, axis: str = "pos") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_call_step(mesh: Mesh, params: ModelParams, dtype=jnp.float32):
    """Returns a jitted function (counts [N,8], quals [N,8], ref [N]) ->
    (gt_prob [N,10], max_gt [N], cg_mask [N], gt_hist [10], cov_hist [64])
    with N sharded over the mesh's 'pos' axis."""
    full = sharded_full_step(mesh, params, dtype)

    def step(counts, quals, ref):
        soa = full(counts, quals, ref)
        return (
            soa["gt_prob"], soa["max_gt"], soa["cg_mask"],
            soa["gt_hist"], soa["cov_hist"],
        )

    return step


def sharded_full_step(mesh: Mesh, params: ModelParams, dtype=jnp.float32):
    """Device-resident sharded calling step producing the full
    call_block_soa surface plus emitter-grade halo context.

    Outputs (dict; N position-sharded over 'pos' unless noted):
      gt_prob [N,10]  log10 posteriors with the C-style max-entry
                      (-log(1+off)/LOG10 absorption, genotype_model.c:240)
      max_gt  [N]     argmax genotype (first max wins)
      margin  [N]     top-2 ll gap (the f64/oracle rescue gate)
      off_sum [N]     off-max exponent sum (GQ phred input)
      covered [N]     any observations
      gt1     [N]     1-based genotype codes, 0 = uncalled
      prev_gt/next_gt [N]  ±1-position genotype codes ACROSS shard
                      borders via ppermute halo — what the emitter's
                      5-state CG automaton reads at slab edges
                      (print_vcf.c:231-266)
      prev_skip/next_skip [N]  neighbour hom-ref-skip bits (the masked
                      lag-slot state the automaton sees, print_vcf.c:139)
      cg_mask [N]     called-CpG pair mask (CpG-pair stats ownership =
                      the left position's shard, print_vcf.c:446-474)
      gt_hist [10], cov_hist [64]  psum-merged over all shards
    """
    axis = mesh.axis_names[0]
    nsh = mesh.devices.size

    def local_step(counts, quals, ref):
        ll = genotype_log_likelihoods(counts, quals, ref, params, dtype)
        mx = jnp.argmax(ll, axis=-1).astype(jnp.int32)
        mval = jnp.max(ll, axis=-1, keepdims=True)
        onehot = jax.nn.one_hot(mx, 10, dtype=bool)
        masked = jnp.where(onehot, -jnp.inf, ll)
        margin = mval[:, 0] - jnp.max(masked, axis=-1)
        off_sum = jnp.sum(jnp.where(onehot, 0, jnp.exp(ll - mval)), axis=-1)
        s = jnp.log1p(off_sum)
        gt_prob = (ll - mval - s[:, None]) / LOG10
        # C-style max-entry absorption so the GQ phred chain matches
        gt_prob = jnp.where(
            onehot, (-jnp.log1p(off_sum) / LOG10)[:, None], gt_prob
        )
        covered = counts.sum(axis=-1) > 0
        gt1 = jnp.where(covered, mx + 1, 0)  # 1-based codes, 0 = uncalled
        # hom-ref skip bit (AA/TT matching ref, print_vcf.c:139): the
        # emitter needs its neighbours' skip state for CG bookkeeping
        skip = ((gt1 == 1) & (ref == 1)) | ((gt1 == 10) & (ref == 4))

        # 1-position halo exchange at slab borders (ring ppermute; ends
        # masked to the uncalled state)
        def halo(v, fill):
            right = jax.lax.ppermute(
                v[-1:], axis, [(i, (i + 1) % nsh) for i in range(nsh)]
            )
            left = jax.lax.ppermute(
                v[:1], axis, [(i, (i - 1) % nsh) for i in range(nsh)]
            )
            idx = jax.lax.axis_index(axis)
            prev_v = jnp.where(idx == 0, fill, right[0])
            next_v = jnp.where(idx == nsh - 1, fill, left[0])
            return (
                jnp.concatenate([prev_v[None], v[:-1]]),
                jnp.concatenate([v[1:], next_v[None]]),
            )

        g_prev, g_next = halo(gt1, jnp.int32(0))
        s_prev, s_next = halo(skip, False)
        cg_mask = ((gt1 == 5) & (g_next == 8)) | ((gt1 == 8) & (g_prev == 5))

        gt_hist = jnp.zeros(10, jnp.int32).at[mx].add(
            covered.astype(jnp.int32)
        )
        gt_hist = jax.lax.psum(gt_hist, axis)
        depth = jnp.clip(counts.sum(axis=-1), 0, 63).astype(jnp.int32)
        cov_hist = jnp.zeros(64, jnp.int32).at[depth].add(
            covered.astype(jnp.int32)
        )
        cov_hist = jax.lax.psum(cov_hist, axis)
        return (
            gt_prob, mx, margin, off_sum, covered, gt1, g_prev, g_next,
            s_prev, s_next, cg_mask, gt_hist, cov_hist,
        )

    shmapped = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=tuple([P(axis)] * 11 + [P(), P()]),
        )
    )
    keys = (
        "gt_prob", "max_gt", "margin", "off_sum", "covered", "gt1",
        "prev_gt", "next_gt", "prev_skip", "next_skip", "cg_mask",
        "gt_hist", "cov_hist",
    )

    def step(counts, quals, ref):
        return dict(zip(keys, shmapped(counts, quals, ref)))

    return step


def shard_positions(mesh: Mesh, *arrays):
    """Device-put position-major arrays with the pos axis sharded."""
    axis = mesh.axis_names[0]
    out = []
    for a in arrays:
        spec = P(axis) if a.ndim == 1 else P(axis, None)
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Production mesh kernels (used by pipeline.engine.CallEngine)
# ---------------------------------------------------------------------------
# This carries the exact single-device contract of ops.genotype.call_genotypes
# with the position axis sharded over the mesh. The model is a pure
# per-position map, so the sharded program runs the identical
# elementwise/gather graph on each slab and needs no collectives — outputs
# are bitwise equal to the single-device kernel, which is what lets
# the production engine switch to the mesh whenever >1 device is present
# without disturbing the exactness tiers (f64 rescue + scalar oracle).


def sharded_call_genotypes(mesh: Mesh, params, dtype):
    """jit(shard_map) of ops.genotype.call_genotypes over the mesh:
    (counts [B,8], quals [B,8], ref [B]) ->
    (gt_prob [B,10], max_gt [B], margin [B], off_sum [B]), B % ndev == 0."""
    from bs_call_tpu.ops.genotype import call_genotypes

    axis = mesh.axis_names[0]

    def local(counts, quals, ref):
        return call_genotypes(counts, quals, ref, params, dtype=dtype)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
        )
    )


def usable_device_count(n_devices: int, batch: int) -> int:
    """Largest power of two <= n_devices that divides the batch size (the
    fixed compiled chunk shape must split evenly over the mesh)."""
    n = 1
    while n * 2 <= n_devices and batch % (n * 2) == 0:
        n *= 2
    return n
