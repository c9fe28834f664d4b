"""Vectorized 10-genotype bisulfite likelihood model (JAX).

Device re-design of the reference inner loop (genotype_model.c:44-246 and
call_genotypes.c:43-60): instead of one C function call per genome position,
whole blocks of positions are evaluated as a single fused elementwise
program. All per-quality terms are gathers into the tables from
`bs_call_tpu.ops.tables`; `get_Z` is closed-form, so the kernel contains no
loops and no data-dependent control flow.

dtype is parametric: float32 for the --no-exact fast path, float64 for the
exact tiers (the GPU column and fused engines, and the oracle
cross-checks); float64 needs jax_enable_x64.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from bs_call_tpu.constants import LOG10
from bs_call_tpu.ops.tables import NONINF_SEL, qual_tables, ref_prior_matrix


@dataclass(frozen=True)
class ModelParams:
    """Static model parameters (subset of the reference's sr_param)."""

    under_conv: float = 0.01
    over_conv: float = 0.05
    ref_bias: float = 2.0

    def __hash__(self):
        return hash((self.under_conv, self.over_conv, self.ref_bias))


def _get_z(x1, x2, k1, k2, l: float, t: float, dtype):
    """Vectorized get_Z (genotype_model.c:23-42): analytic maximization of the
    per-genotype likelihood over the methylation proportion for the three
    (w, p) configurations. Returns [..., 3]."""
    lpt = l + t
    lmt = l - t
    d = (x1 + x2) * lmt
    d = jnp.where(d == 0, jnp.asarray(1.0, dtype), d)  # masked later
    zs = []
    for a1, a2 in (
        (lpt + 2.0 * k2, 2.0 - lpt + 2.0 * k1),
        (2.0 + lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
        (lpt + 4.0 * k2, 2.0 - lpt + 4.0 * k1),
    ):
        sinm = (x1 * a1 - x2 * a2) / d
        sinm = jnp.clip(sinm, -1.0, 1.0)
        zs.append(0.5 * (lmt * sinm + 2.0 - lpt))
    return jnp.stack(zs, axis=-1)


def _safe_log(x, dtype):
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
    return jnp.log(jnp.maximum(x, tiny))


@functools.partial(jax.jit, static_argnames=("params", "dtype"))
def genotype_log_likelihoods(counts, quals, ref, params: ModelParams, dtype=jnp.float32):
    """Per-position genotype log-likelihoods.

    counts: [N, 8] float/int — category counts (ACGT noninf, ACGT informative)
    quals:  [N, 8] int32 — per-category average base quality (0..MAX_QUAL)
    ref:    [N] int32 — reference base code 0..4 (N,A,C,G,T)
    Returns ll: [N, 10] in `dtype` (natural-log likelihoods incl. ref prior).
    """
    qt = qual_tables(np.dtype(dtype))
    k_t = jnp.asarray(qt.k)
    lnk_t = jnp.asarray(qt.ln_k)
    lnkh_t = jnp.asarray(qt.ln_k_half)
    lnk1_t = jnp.asarray(qt.ln_k_one)
    prior = jnp.asarray(ref_prior_matrix(params.ref_bias, np.dtype(dtype)))

    n = counts.astype(dtype)
    k = k_t[quals]      # [N, 8]
    lnk = lnk_t[quals]
    lnkh = lnkh_t[quals]
    lnk1 = lnk1_t[quals]

    ll = prior[ref]  # [N, 10]

    # --- non-informative categories (genotype_model.c:109-164) ---
    sel = jnp.asarray(NONINF_SEL)  # [4, 10] codes in {0,1,2}
    for i in range(4):
        coef = jnp.where(
            sel[i] == 2,
            lnk1[:, i : i + 1],
            jnp.where(sel[i] == 1, lnkh[:, i : i + 1], lnk[:, i : i + 1]),
        )  # [N, 10]
        ll = ll + jnp.where(n[:, i : i + 1] > 0, n[:, i : i + 1] * coef, 0)

    # --- methylation-informative categories (genotype_model.c:165-230) ---
    l = 1.0 - params.under_conv
    t = params.over_conv
    # Z[0..2] from (C-informative, T-informative) counts; Z[3..5] from (G, A).
    z_ct = _get_z(n[:, 5], n[:, 7], k[:, 5], k[:, 7], l, t, dtype)  # [N,3]
    z_ga = _get_z(n[:, 6], n[:, 4], k[:, 6], k[:, 4], l, t, dtype)  # [N,3]
    Z0, Z1, Z2 = z_ct[:, 0], z_ct[:, 1], z_ct[:, 2]
    Z3, Z4, Z5 = z_ga[:, 0], z_ga[:, 1], z_ga[:, 2]

    def cat_contrib(ni, cols):
        """cols: list of 10 [N] coefficient arrays in genotype order."""
        coef = jnp.stack(cols, axis=-1)  # [N, 10]
        return jnp.where(ni[:, None] > 0, ni[:, None] * coef, 0)

    # category 4: A informative (G2A strand A observations)
    k4, lg = k[:, 4], lambda x: _safe_log(x, dtype)
    t58 = lg(0.5 * (1.0 - Z5) + k4)
    ll = ll + cat_contrib(
        n[:, 4],
        [
            lnk1[:, 4],                    # AA
            lnkh[:, 4],                    # AC
            lg(1.0 - 0.5 * Z4 + k4),       # AG
            lnkh[:, 4],                    # AT
            lnk[:, 4],                     # CC
            t58,                           # CG
            lnk[:, 4],                     # CT
            lg(1.0 - Z3 + k4),             # GG
            t58,                           # GT
            lnk[:, 4],                     # TT
        ],
    )
    # category 5: C informative
    k5 = k[:, 5]
    t15 = lg(0.5 * Z2 + k5)
    ll = ll + cat_contrib(
        n[:, 5],
        [
            lnk[:, 5],                     # AA
            t15,                           # AC
            lnk[:, 5],                     # AG
            lnk[:, 5],                     # AT
            lg(Z0 + k5),                   # CC
            t15,                           # CG
            lg(0.5 * Z1 + k5),             # CT
            lnk[:, 5],                     # GG
            lnk[:, 5],                     # GT
            lnk[:, 5],                     # TT
        ],
    )
    # category 6: G informative
    k6 = k[:, 6]
    t58b = lg(0.5 * Z5 + k6)
    ll = ll + cat_contrib(
        n[:, 6],
        [
            lnk[:, 6],                     # AA
            lnk[:, 6],                     # AC
            lg(0.5 * Z4 + k6),             # AG
            lnk[:, 6],                     # AT
            lnk[:, 6],                     # CC
            t58b,                          # CG
            lnk[:, 6],                     # CT
            lg(Z3 + k6),                   # GG
            t58b,                          # GT
            lnk[:, 6],                     # TT
        ],
    )
    # category 7: T informative
    k7 = k[:, 7]
    t15b = lg(0.5 * (1.0 - Z2) + k7)
    ll = ll + cat_contrib(
        n[:, 7],
        [
            lnk[:, 7],                     # AA
            t15b,                          # AC
            lnk[:, 7],                     # AG
            lnkh[:, 7],                    # AT
            lg(1.0 - Z0 + k7),             # CC
            t15b,                          # CG
            lg(1.0 - 0.5 * Z1 + k7),       # CT
            lnk[:, 7],                     # GG
            lnkh[:, 7],                    # GT
            lnk1[:, 7],                    # TT
        ],
    )
    return ll


@functools.partial(jax.jit, static_argnames=("params", "dtype"))
def call_genotypes(counts, quals, ref, params: ModelParams, dtype=jnp.float32):
    """Full calc_gt_prob: returns (gt_prob_log10 [N,10], max_gt [N] int32,
    margin [N]).

    Matches genotype_model.c:231-245: argmax (first max wins) then log10
    posterior normalization over the 10 genotypes. `margin` is the gap
    between the best and second-best log-likelihood; positions with a tiny
    margin are candidates for the float64 libm rescue path (XLA's log/exp
    differ from libm in the last ulp, which can flip exact ties).
    """
    ll = genotype_log_likelihoods(counts, quals, ref, params, dtype)
    mx = jnp.argmax(ll, axis=-1).astype(jnp.int32)
    mval = jnp.max(ll, axis=-1, keepdims=True)
    onehot = jax.nn.one_hot(mx, 10, dtype=bool)
    # second-best: mask out the argmax and take the max again
    masked = jnp.where(onehot, -jnp.inf, ll)
    margin = mval[:, 0] - jnp.max(masked, axis=-1)
    # off-max exponent sum, computed separately so it does not get absorbed
    # into 1.0 in float32 (the GQ phred needs 1-p with full relative
    # precision)
    off_sum = jnp.sum(
        jnp.where(onehot, 0, jnp.exp(ll - mval)), axis=-1
    )
    s = jnp.log1p(off_sum)
    gt_prob = (ll - mval - s[:, None]) / LOG10
    return gt_prob, mx, margin, off_sum
