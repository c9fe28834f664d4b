"""Device-side pileup build + fused pileup->genotype step.

Device re-design of the reference's pileup accumulation
(call_genotypes.c:180-226) for co-located deployments: instead of building
`counts2/qual_sum/mapq2_sum` on the host and shipping pileup COLUMNS to the
device, the (much smaller) normalized READ batch crosses the boundary once
and the scatter-add runs on the device as a segment-sum, fused by XLA with
the genotype kernel that consumes it (SURVEY §7.2-3/M4). Per base the
observation stream is (position, category, qual, orientation, mapq) exactly
as ops/pileup.py's host path; category mapping is the 3x4 strand LUT
gather.

Read batch layout (padded, fixed shape => one compiled executable):
    rd      [R, L] uint8   (base&3 | qual<<2), 0-padded
    starts  [R]    int32   block-relative ref position of byte 0
    ori     [R]    int32   orientation row (0/1)
    strand  [R]    int32   bisulfite strand code (0/1/2)
    mapq    [R]    int32
Padding rows use starts < 0 so every byte lands in the dump segment.

Counts are integer-exact. The f32 qual sums add integers below 64, so
they are exact in any accumulation order below 2^24. The mapq^2 sums
(3,600 per read at MAPQ 60) leave f32's exact-integer range past 2^24,
about 4,660 reads at one position; there GPU scatter-add order makes them
vary from run to run, so the fused tier does not use them (MQ comes from
the host pileup).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bs_call_tpu.constants import BASE_TAB_ST, FLT_QUAL


@functools.partial(jax.jit, static_argnames=("n_pos", "min_qual"))
def device_pileup(rd, starts, ori, strand, mapq, n_pos: int, min_qual: int):
    """Returns (counts2 [P,2,8] i32, qual_sum [P,8] f32, mapq2_sum [P] f32)
    for block-relative positions [0, n_pos)."""
    R, L = rd.shape
    q = (rd >> 2).astype(jnp.int32)              # [R, L]
    base = (rd & 3).astype(jnp.int32)
    tab = jnp.asarray(BASE_TAB_ST, dtype=jnp.int32)      # [3, 4]
    cat = tab[strand[:, None], base]             # [R, L]
    pos = starts[:, None] + jnp.arange(L, dtype=jnp.int32)[None, :]

    # leading/trailing trim (call_genotypes.c:196-213): bases outside the
    # first..last live (q>0, q!=FLT) byte of each read are dropped; the
    # per-base min-qual check handles interior masked bases
    live = (q > 0) & (q != FLT_QUAL)
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    big = jnp.int32(1 << 30)
    lo = jnp.min(jnp.where(live, j, big), axis=1, keepdims=True)
    hi = jnp.max(jnp.where(live, j, -1), axis=1, keepdims=True)
    valid = (
        (j >= lo)
        & (j <= hi)
        & (q >= min_qual)
        & (q != FLT_QUAL)
        & (pos >= 0)
        & (pos < n_pos)
    )

    # counts2: segment per (pos, ori, cat); invalid bytes -> dump row
    seg16 = jnp.where(valid, pos * 16 + ori[:, None] * 8 + cat, n_pos * 16)
    ones = valid.astype(jnp.int32)
    counts2 = jax.ops.segment_sum(
        ones.ravel(), seg16.ravel(), num_segments=n_pos * 16 + 1
    )[:-1].reshape(n_pos, 2, 8)
    # qual_sum: segment per (pos, cat)
    seg8 = jnp.where(valid, pos * 8 + cat, n_pos * 8)
    qual_sum = jax.ops.segment_sum(
        jnp.where(valid, q, 0).astype(jnp.float32).ravel(),
        seg8.ravel(),
        num_segments=n_pos * 8 + 1,
    )[:-1].reshape(n_pos, 8)
    # mapq^2: segment per pos
    segp = jnp.where(valid, pos, n_pos)
    mq2 = (mapq * mapq).astype(jnp.float32)[:, None] * valid.astype(
        jnp.float32
    )
    mapq2_sum = jax.ops.segment_sum(
        mq2.ravel(), segp.ravel(), num_segments=n_pos + 1
    )[:-1]
    return counts2, qual_sum, mapq2_sum


@functools.partial(
    jax.jit, static_argnames=("n_pos", "min_qual", "params", "dtype")
)
def fused_pileup_call(
    rd, starts, ori, strand, mapq, ref_codes, n_pos: int, min_qual: int,
    params, dtype=jnp.float32,
):
    """Fused read-batch -> genotype call: pileup scatter-add, per-position
    aggregation (float32 semantics of call_genotypes.c:45-59), and the
    10-genotype model in ONE compiled program. Only read bytes go H2D and
    only call outputs come D2H. Returns
    (gt_prob, max_gt, margin, off_sum, counts2, qual_sum, mapq2_sum).

    Caveat vs the exact tiers: MQ's sqrt runs in the kernel dtype (the
    reference uses a float64 sqrt); this step is the fast/fused tier for
    co-located accelerators, not the byte-parity tier."""
    from bs_call_tpu.ops.genotype import call_genotypes

    counts2, qual_sum, mapq2_sum = device_pileup(
        rd, starts, ori, strand, mapq, n_pos, min_qual
    )
    counts = counts2.sum(axis=1)                      # [P, 8] i32
    nn = counts.astype(jnp.float32)
    avg = qual_sum / jnp.where(nn > 0, nn, 1.0)
    quals = jnp.where(
        counts > 0, jnp.floor(0.5 + avg), 0.0
    ).astype(jnp.int32)
    gt_prob, max_gt, margin, off = call_genotypes(
        counts, quals, ref_codes, params, dtype=dtype
    )
    return gt_prob, max_gt, margin, off, counts2, qual_sum, mapq2_sum


def _agg_quals_f32(counts, qual_sum):
    """Per-category rounded average quality with the reference's float32
    semantics (call_genotypes.c:45-59; native aggregate()):
    (int)floorf(0.5f + qual_sum / (float)count), 0 where count==0."""
    nn = counts.astype(jnp.float32)
    avg = qual_sum / jnp.where(counts > 0, nn, jnp.float32(1))
    return jnp.where(
        counts > 0, jnp.floor(jnp.float32(0.5) + avg), jnp.float32(0)
    ).astype(jnp.int32)


def _model_f64(counts2, qual_sum, ref_codes, params):
    from bs_call_tpu.ops.genotype import call_genotypes

    counts = counts2.sum(axis=1)
    quals = _agg_quals_f32(counts, qual_sum)
    gt_prob, max_gt, margin, off = call_genotypes(
        counts, quals, ref_codes, params, dtype=jnp.float64
    )
    return gt_prob, max_gt, margin, off, quals.astype(jnp.uint8)


@functools.partial(
    jax.jit, static_argnames=("n_pos", "min_qual", "params")
)
def fused_ll_f64(rd, starts, ori, strand, mapq, ref_codes, n_pos: int,
                 min_qual: int, params):
    """Fused exact tier, single device: read batch -> pileup scatter-add
    -> f32 aggregation -> float64 10-genotype model, one compiled
    program. Only read bytes cross H2D; D2H is the model's
    (gt_prob, max_gt, margin, off_sum) plus the uint8 quals (the host
    compares them against its own C++ aggregate and rescues any
    f32-boundary mismatch through the oracle, so output bytes never
    depend on device float behavior). Replaces the pileup +
    calc_gt_prob hot loops (call_genotypes.c:180-226,
    genotype_model.c:44-246) on device. Needs jax_enable_x64."""
    counts2, qual_sum, _m2 = device_pileup(
        rd, starts, ori, strand, mapq, n_pos, min_qual
    )
    return _model_f64(counts2, qual_sum, ref_codes, params)


def sharded_fused_ll_f64(mesh, params, n_pos: int, min_qual: int):
    """Multi-device fused exact tier: reads are data-parallel over the
    mesh ('pos' axis reused as the device axis), each device builds a
    full-width partial pileup from its read shard, one psum merges the
    integer counts and f32 qual sums, and each device then runs the f64
    model on its own contiguous position slab. The qual sums are sums
    of small integers, exact in f32 in any order.

    Returns fn(rd, starts, ori, strand, mapq, ref) ->
    (gt_prob, max_gt, margin, off_sum, quals_u8) with R % ndev == 0 and
    n_pos % ndev == 0."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    nd = mesh.devices.size
    if n_pos % nd:
        raise ValueError(f"n_pos={n_pos} does not divide over {nd} devices")
    shard = n_pos // nd

    def local(rd, starts, ori, strand, mapq, ref_shard):
        counts2, qual_sum, _m2 = device_pileup(
            rd, starts, ori, strand, mapq, n_pos, min_qual
        )
        counts2 = jax.lax.psum(counts2, axis)
        qual_sum = jax.lax.psum(qual_sum, axis)
        i = jax.lax.axis_index(axis)
        c2 = jax.lax.dynamic_slice_in_dim(counts2, i * shard, shard)
        qs = jax.lax.dynamic_slice_in_dim(qual_sum, i * shard, shard)
        return _model_f64(c2, qs, ref_shard, params)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis),) * 6,
            out_specs=(P(axis),) * 5,
        )
    )


def pad_read_batch(reads: dict, lo: int, hi: int, r_pad: int, l_cap: int):
    """Slice a block's read batch to the rows that can touch positions
    [lo, hi] (block-relative), shift starts to lo, and pad to the fixed
    (r_pad, l_cap) device shape. Returns (rd, starts, ori, strand, mapq)
    or None when the live rows exceed r_pad / l_cap (caller falls back).
    Padding rows are all-zero bytes: q==0 is never live, so they
    contribute to no segment regardless of their start."""
    starts = reads["starts"]
    lens = reads["lens"]
    keep = (starts <= hi) & (starts + lens - 1 >= lo)
    n = int(keep.sum())
    if n > r_pad or reads["rd"].shape[1] > l_cap:
        return None
    L = reads["rd"].shape[1]
    rd = np.zeros((r_pad, l_cap), np.uint8)
    rd[:n, :L] = reads["rd"][keep]
    out_starts = np.zeros(r_pad, np.int32)
    out_starts[:n] = starts[keep] - lo
    cols = []
    for k in ("ori", "strand", "mapq"):
        a = np.zeros(r_pad, np.int32)
        a[:n] = reads[k][keep]
        cols.append(a)
    return (rd, out_starts, *cols)


def pack_reads(align_list, x, max_len=None):
    """Host-side packing of a normalized block into the padded device
    layout. Returns (rd, starts, ori, strand, mapq) numpy arrays."""
    rows = []
    for al in align_list:
        o = al.orientation
        for k in range(2):
            rdk = al.read[k]
            if rdk is not None and len(rdk):
                p0 = al.reverse_position if k else al.forward_position
                rows.append((rdk, p0 - x, o, al.bs_strand, al.mapq[k]))
            o ^= 1
    if not rows:
        L = max_len or 1
        return (
            np.zeros((0, L), np.uint8),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
        )
    L = max_len or max(len(r[0]) for r in rows)
    R = len(rows)
    rd = np.zeros((R, L), np.uint8)
    starts = np.empty(R, np.int32)
    ori = np.empty(R, np.int32)
    strand = np.empty(R, np.int32)
    mapq = np.empty(R, np.int32)
    for i, (r, p0, o, st, mq) in enumerate(rows):
        rd[i, : len(r)] = r[:L]
        starts[i] = p0
        ori[i] = o
        strand[i] = st
        mapq[i] = mq
    return rd, starts, ori, strand, mapq
