"""Vectorized per-block VCF emission.

Computes every output field of _print_vcf_entry (print_vcf.c:32-527) as
position-major numpy arrays for a whole pileup block at once, then formats
text rows in a tight loop. Semantics match the scalar SiteEmitter exactly,
including the 2-position lag pipeline quirks:

  - the lookahead slots at block end hold stale duplicates of the last
    genotype (flush_vcf_entries, print_vcf.c:540-541) — captured by padding
    the genotype array with two copies of its last element;
  - reference-context truncation at the first N (strncpy semantics) with
    block-edge windows fixed up scalar (first two and last two positions).

The runner hands this emitter stats, dbSNP and (for BCF outputs) a
BcfWriter, so it serves every output type; small or edge blocks still run
the scalar SiteEmitter (the behavioral reference implementation).
"""

from __future__ import annotations

import math

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from bs_call_tpu.constants import GT_HET, LOG10
from bs_call_tpu.output.site import (
    ALL_IDX,
    CS_STR,
    GT_FLAG,
    GT_INT,
    IUPAC,
    PBASE,
    REF_ALT,
    CFLAG,
    GFLAG,
)

# ---- static LUT construction ----


def _gl_layout(gt: int, rfix: int):
    """Slot list for the GL vector (print_vcf.c:318-347); -2 = literal
    -99.999."""
    aix = ALL_IDX[gt][rfix]
    slots = []
    if rfix:
        slots.append(rfix * (9 - rfix) // 2 + rfix - 5)
    else:
        slots.append(-2)
    for i in range(2):
        if aix[i] <= 0:
            break
        if rfix:
            a, b = min(rfix, aix[i]), max(rfix, aix[i])
            slots.append(a * (9 - a) // 2 + b - 5)
        slots.append(aix[i] * (9 - aix[i]) // 2 + aix[i] - 5)
    return slots


GL_IDX = np.full((10, 5, 5), -1, dtype=np.int32)
GL_LEN = np.zeros((10, 5), dtype=np.int32)
for _g in range(10):
    for _r in range(5):
        sl = _gl_layout(_g, _r)
        GL_LEN[_g, _r] = len(sl)
        GL_IDX[_g, _r, : len(sl)] = sl

GT_STR = [["" for _ in range(5)] for _ in range(10)]
for _g in range(10):
    for _r in range(5):
        gg = GT_INT[_g][_r]
        GT_STR[_g][_r] = f"{(gg >> 4 >> 1) - 1}/{((gg & 0xF) >> 1) - 1}"

ALT_STR = [[",".join(REF_ALT[g][r]) or "." for r in range(5)] for g in range(10)]
GT_FLAG_A = np.array(GT_FLAG, dtype=bool)
CFLAG_A = np.array(CFLAG, dtype=bool)
GFLAG_A = np.array(GFLAG, dtype=bool)
GT_HET_A = np.asarray(GT_HET)
PBASE_B = np.frombuffer(PBASE.encode(), dtype=np.uint8)
IUPAC_B = np.frombuffer(IUPAC.encode(), dtype=np.uint8)

# Each failed-filter name carries its terminating NUL in the reference's
# typed char vector (print_vcf.c:283-296 copies the NUL and advances
# past it) — verified byte-for-byte against the compiled C binary
# (tools/htslib_shim/README.md). "PASS" (strcpy + explicit flen=4) does
# not.
FT_STR = []
for _f in range(16):
    if _f:
        names = [n for i, n in enumerate(("q20", "qd2", "fs60", "mq40")) if (_f >> i) & 1]
        FT_STR.append(";".join(n + "\0" for n in names))
    else:
        FT_STR.append("PASS")


from bs_call_tpu.constants import lfact_store, logp_table  # noqa: E402

_LFACT_TAB = lfact_store()
_LOGP = logp_table()


def _lfact_vec(x: np.ndarray) -> np.ndarray:
    """Vectorized log-factorial with the reference's table-then-lgamma
    split (bs_call.h:335)."""
    import math

    x = np.asarray(x, dtype=np.int64)
    out = np.where(x < len(_LFACT_TAB), _LFACT_TAB[np.minimum(x, 255)], 0.0)
    big = np.nonzero(x >= len(_LFACT_TAB))[0]
    for i in big:
        out[i] = math.lgamma(float(x[i]) + 1.0)
    return out


def _truncate_ctx(win: np.ndarray) -> np.ndarray:
    """strncpy-style truncation along the last axis: zero everything after
    the first zero. Fine for the handful of edge-row fixup calls; the
    full-block windows go through _truncate_win1d (logical_and.accumulate
    has no fast bool inner loop and was the single hottest emit op)."""
    keep = np.logical_and.accumulate(win != 0, axis=-1)
    return np.where(keep, win, 0)


def _truncate_win1d(seq: np.ndarray, W: int) -> np.ndarray:
    """sliding_window_view(seq, W) with strncpy truncation, built column
    by column from contiguous 1-D slices: ~10x the strided-accumulate
    form on block-sized windows."""
    n = len(seq) - W + 1
    out = np.empty((n, W), seq.dtype)
    keep = seq[:n] != 0
    np.multiply(seq[:n], keep, out=out[:, 0])
    for j in range(1, W):
        col = seq[j : n + j]
        keep &= col != 0
        np.multiply(col, keep, out=out[:, j])
    return out


MUT_A = None  # built lazily from site.MUT_TYPE
IS_VAR = np.zeros((10, 5), dtype=bool)
IS_MULTI = np.zeros((10, 5), dtype=bool)
from bs_call_tpu.output.site import MUT_TYPE as _MT  # noqa: E402

MUT_A = np.array(_MT, dtype=np.int64)
for _g in range(10):
    for _r in range(5):
        alt = REF_ALT[_g][_r]
        IS_VAR[_g, _r] = alt != ""
        IS_MULTI[_g, _r] = len(alt) > 1


def variant_gate_luts(quirks: bool):
    """(is_var, is_multi) LUTs for the report's variant gate.

    quirks=True reproduces a reference bug: the ALT-encoding loop
    advances `alt` to its NUL terminator (print_vcf.c:177-181), so the
    later stats gate `alt[0] != '.'` (print_vcf.c:400) is TRUE for
    every emitted site — including hom-ref rows emitted via -A or a
    dbSNP selection — and `alt[1] == ','` (:401) reads the byte after
    the terminator, which is never a comma in the compiled string
    table. Net effect in the real binary: every emitted row counts as
    a SNP, Multiallelic stays 0, quality.Variant == quality.All, and
    coverage .var counts every emitted row. Verified against the
    compiled reference (tests/test_reference_matrix.py)."""
    if quirks:
        return (
            np.ones((10, 5), dtype=bool),
            np.zeros((10, 5), dtype=bool),
        )
    return IS_VAR, IS_MULTI


# fixed-stride LUT blobs for the native formatter (shared source of truth
# with the Python fallback loop)
def _lut_blob(entries, stride):
    out = bytearray(len(entries) * stride)
    for i, s in enumerate(entries):
        b = s.encode()
        out[i * stride : i * stride + len(b)] = b
    return bytes(out)


_GT_LUT = _lut_blob([GT_STR[g][r] for g in range(10) for r in range(5)], 8)
_ALT_LUT = _lut_blob([ALT_STR[g][r] for g in range(10) for r in range(5)], 8)
_CS_LUT = _lut_blob(CS_STR, 4)
_FT_LUT = _lut_blob(FT_STR, 24)
# explicit entry lengths: FT entries contain embedded NULs, so the
# native formatters cannot strlen the blob
_FT_LEN = np.ascontiguousarray([len(s) for s in FT_STR], dtype=np.int32)
_PBASE_B5 = PBASE.encode()
_GT_INT_LUT = bytes(
    GT_INT[g][r] for g in range(10) for r in range(5)
)

# BCF dictionary id order (print_vcf.c:755)
BCF_ID_NAMES = [
    "PASS", "fail", "mac1", "CX", "GT", "FT", "GL", "GQ", "DP", "MQ",
    "QD", "MC8", "AMQ", "CS", "CG", "FS",
]


def _native_format_bcf(bcf_writer, ctg, n, g, r, flt, mac1, prf_all,
                       ctx_all, phred, dp1, mq, qd, gl_vals, gl_len, c,
                       q8, cond_cg, cg_code, het, fs_int, pos_e,
                       rs_ids) -> bool:
    try:
        import ctypes

        from bs_call_tpu.native import load

        lib = load()
        if lib is None:
            return False
    except Exception:
        return False
    ids = np.array(
        [bcf_writer.ids[nm] for nm in BCF_ID_NAMES], dtype=np.int32
    )
    if rs_ids is not None:
        blobs = [(s or "").encode() for s in rs_ids]
        rs_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=rs_off[1:])
        rs_blob = b"".join(blobs)
    else:
        rs_off = np.zeros(n + 1, dtype=np.int64)
        rs_blob = b""
    cap = 1024 * (n + 2)
    out = np.empty(cap, dtype=np.uint8)  # uninitialized (see text path)
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)  # noqa: E731
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    u8 = lambda a: np.ascontiguousarray(a, dtype=np.uint8)  # noqa: E731
    P = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    arrs = dict(
        pos=i64(pos_e), g=i32(g), r=i32(r), flt=i64(flt), mac=u8(mac1),
        ph=i64(phred), dp=i64(dp1), mq=i32(mq), qd=i64(qd), fs=i64(fs_int),
        het=u8(het), glv=np.ascontiguousarray(gl_vals, dtype=np.float32),
        gll=i32(gl_len), c=i32(c), q=i32(q8), cg=u8(cond_cg),
        cgc=i64(cg_code),
    )
    written = lib.bsc_format_bcf(
        ctypes.c_int64(n), ctypes.c_int32(ctg.vcf_rid),
        ids.ctypes.data_as(ctypes.c_void_p),
        P(arrs["pos"]), P(arrs["g"]), P(arrs["r"]), P(arrs["flt"]),
        P(arrs["mac"]), P(arrs["ph"]), P(arrs["dp"]), P(arrs["mq"]),
        P(arrs["qd"]), P(arrs["fs"]), P(arrs["het"]), P(arrs["glv"]),
        P(arrs["gll"]), P(arrs["c"]), P(arrs["q"]), P(arrs["cg"]),
        P(arrs["cgc"]),
        prf_all, ctx_all,
        rs_off.ctypes.data_as(ctypes.c_void_p), rs_blob,
        _ALT_LUT, 8, _CS_LUT, 4, _FT_LUT, 24,
        _FT_LEN.ctypes.data_as(ctypes.c_void_p), _PBASE_B5, _GT_INT_LUT,
        P(out), ctypes.c_int64(cap),
    )
    if written < 0:
        return False
    bcf_writer._w.write(memoryview(out.data)[:written])
    return True


_HET_U8 = np.ascontiguousarray(GT_HET_A, dtype=np.uint8)
_CFLAG_U8 = np.ascontiguousarray(CFLAG_A, dtype=np.uint8)
_GFLAG_U8 = np.ascontiguousarray(GFLAG_A, dtype=np.uint8)
_GL_IDX_C = np.ascontiguousarray(GL_IDX, dtype=np.int32)
_GL_LEN_C = np.ascontiguousarray(GL_LEN, dtype=np.int32)


def _native_emit_prep(n, counts, gt_prob, g, r, mq, fs, g1, g2, g3):
    """Per-row emit-field prep in C++ (bsc_emit.cpp): phred/QD/FS/filter
    bits/mac1/GL/CG codes/het with the libm the C binary links. Returns
    None when the native library is unavailable (numpy fallback)."""
    try:
        import ctypes

        from bs_call_tpu.native import load

        lib = load()
        if lib is None:
            return None
    except Exception:
        return None
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    f64 = lambda a: np.ascontiguousarray(a, dtype=np.float64)  # noqa: E731
    P = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    ins = dict(
        counts=i32(counts), gp=f64(gt_prob), g=i32(g), r=i32(r),
        mq=i32(mq), fs=f64(fs), g1=i32(g1), g2=i32(g2), g3=i32(g3),
    )
    phred = np.empty(n, np.int64)
    dp1 = np.empty(n, np.int64)
    qd = np.empty(n, np.int64)
    fs_int = np.empty(n, np.int64)
    flt = np.empty(n, np.int64)
    mac1 = np.empty(n, np.uint8)
    gl_vals = np.empty((n, 5), np.float32)
    gl_len = np.empty(n, np.int32)
    cg_code = np.empty(n, np.int64)
    cond_cg = np.empty(n, np.uint8)
    het = np.empty(n, np.uint8)
    lib.bsc_emit_prep(
        ctypes.c_int64(n),
        P(ins["counts"]), P(ins["gp"]), P(ins["g"]), P(ins["r"]),
        P(ins["mq"]), P(ins["fs"]), P(ins["g1"]), P(ins["g2"]),
        P(ins["g3"]),
        P(_GL_IDX_C), P(_GL_LEN_C), P(_HET_U8), P(_CFLAG_U8),
        P(_GFLAG_U8),
        P(phred), P(dp1), P(qd), P(fs_int), P(flt), P(mac1),
        P(gl_vals), P(gl_len), P(cg_code), P(cond_cg), P(het),
    )
    return (
        phred, dp1, qd, fs_int, flt, mac1.astype(bool), gl_vals,
        gl_len, cg_code, cond_cg.astype(bool), het.astype(bool),
    )


def _native_format(fileobj, ctg, n, g, r, flt, mac1, prf_all, ctx_all,
                   phred, dp1, mq, qd, gl_vals, gl_len, c, q8, cond_cg,
                   cg_code, het, fs_int, pos_e, rs_ids) -> bool:
    """Format rows via the C++ formatter; returns False if unavailable."""
    try:
        import ctypes

        from bs_call_tpu.native import load

        lib = load()
        if lib is None:
            return False
    except Exception:
        return False
    if rs_ids is not None:
        blobs = [(s or "").encode() for s in rs_ids]
        rs_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=rs_off[1:])
        rs_blob = b"".join(blobs)
    else:
        rs_off = np.zeros(n + 1, dtype=np.int64)
        rs_blob = b""
    cap = 512 * (n + 2)
    # uninitialized buffer: create_string_buffer zero-fills the whole
    # capacity (~150 MB for a 300k-row block), which showed up in profiles
    out = np.empty(cap, dtype=np.uint8)
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)  # noqa: E731
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    u8 = lambda a: np.ascontiguousarray(a, dtype=np.uint8)  # noqa: E731
    P = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    pos_a = i64(pos_e)
    g_a = i32(g)
    r_a = i32(r)
    flt_a = i64(flt)
    mac_a = u8(mac1)
    ph_a = i64(phred)
    dp_a = i64(dp1)
    mq_a = i32(mq)
    qd_a = i64(qd)
    fs_a = i64(fs_int)
    het_a = u8(het)
    glv = np.ascontiguousarray(gl_vals, dtype=np.float32)
    gll = i32(gl_len)
    c_a = i32(c)
    q_a = i32(q8)
    cg_a = u8(cond_cg)
    cgc = i64(cg_code)
    from bs_call_tpu.ops.genotype_native import _n_threads

    written = lib.bsc_format_rows(
        ctypes.c_int64(n),
        ctg.name.encode(),
        P(pos_a), P(g_a), P(r_a), P(flt_a), P(mac_a), P(ph_a), P(dp_a),
        P(mq_a), P(qd_a), P(fs_a), P(het_a), P(glv), P(gll), P(c_a),
        P(q_a), P(cg_a), P(cgc),
        prf_all, ctx_all,
        rs_off.ctypes.data_as(ctypes.c_void_p), rs_blob,
        _GT_LUT, 8, _ALT_LUT, 8, _CS_LUT, 4, _FT_LUT, 24,
        _FT_LEN.ctypes.data_as(ctypes.c_void_p), _PBASE_B5,
        P(out), ctypes.c_int64(cap), ctypes.c_int32(_n_threads()),
    )
    if written < 0:
        return False
    fileobj.write(memoryview(out.data)[:written])
    return True


class VectorBlockEmitter:
    """Block-vectorized text emission; shares dedup + CpG-pair state with
    the caller through old_ctg/old_x/prev_cpg attributes (matching the
    scalar emitter)."""

    def __init__(self, cfg, fileobj, stats=None, dbsnp=None,
                 bcf_writer=None):
        self.cfg = cfg
        self._f = fileobj
        self._bcf = bcf_writer
        self.stats = stats
        self.dbsnp = dbsnp
        self._dbsnp_ctg = None
        self._dbsnp_ctg_name = None
        self.old_ctg = None
        self.old_x = 0
        self.prev_cpg_x = 0
        self.prev_cpg_flt = False
        self._nacc = None  # native stats accumulator (lazy)
        self._nacc_tried = False

    def finalize_stats(self, table) -> None:
        """Fold natively accumulated report counters into self.stats
        (no-op on the pure-numpy path). Must run before the stats are
        reported, pickled to a shard parent, or psum-merged."""
        if self._nacc is not None:
            self._nacc.merge_into(self.stats, table)
            self._nacc = None

    def emit_block(self, ctg, soa, ref_window, x: int, y: int,
                   hold_back: int = 0) -> None:
        """Emit rows for positions [x, y - hold_back].

        hold_back > 0 streams one semantic block through several calls:
        a non-final chunk withholds its last `hold_back` (=2) rows — they
        only provide the ±2 genotype/reference lookahead — and the next
        chunk passes arrays starting 2 before its first unemitted
        position so every emitted row sees real context instead of the
        head/tail padding. Cross-chunk dedup rides the existing old_x
        gate (already-emitted and uncovered rows never re-enter `reach`),
        so output and stats are byte-identical to one whole-block call.
        """
        sz = y - x + 1
        covered = soa["covered"]
        gt1 = np.where(covered, soa["max_gt"] + 1, 0).astype(np.int32)
        if self.old_ctg is not ctg:
            self.old_ctg = ctg
            self.old_x = 0
        if self.dbsnp is not None and self._dbsnp_ctg_name != ctg.name:
            self._dbsnp_ctg = self.dbsnp.load_contig(ctg.name)
            self._dbsnp_ctg_name = ctg.name

        # genotype 5-windows with stale-tail padding
        G_ext = np.concatenate(
            [np.zeros(2, np.int32), gt1, np.repeat(gt1[-1:], 2)]
        )
        g5 = sliding_window_view(G_ext, 5)  # [sz, 5]

        # reference 7-windows with strncpy truncation; rows 0,1 and the two
        # flush rows need scalar fixups
        ref_window = np.asarray(ref_window, dtype=np.uint8)
        T = _truncate_win1d(ref_window[: sz + 2], 7)  # [sz-4, 7]
        rf7 = np.zeros((sz, 7), dtype=np.uint8)
        rf7[2 : sz - 2] = T[: sz - 4]
        # first two positions: push offsets < 4 (print_vcf.c:576-580)
        t0 = _truncate_ctx(ref_window[None, :5])[0]
        rf7[0, 2:7] = t0
        t1 = _truncate_ctx(ref_window[None, :6])[0]
        rf7[1, 1:7] = t1
        # flush rows: shifted copies of the push-y window
        o = _truncate_ctx(ref_window[None, sz - 5 : sz + 2])[0]
        rf7[sz - 2] = np.concatenate([o[1:7], o[6:7]])
        rf7[sz - 1] = np.concatenate([o[2:7], o[6:7], o[6:7]])

        rfix = rf7[:, 2].astype(np.int32)
        gt = g5[:, 2] - 1  # -1 where uncovered

        # emission gating (covered, dedup, hom-ref skip, contig length)
        pos = np.arange(x, y + 1)
        reach = covered & (pos > self.old_x)
        if hold_back:
            reach = reach & (pos <= y - hold_back)
        if reach.any():
            self.old_x = int(pos[reach].max())
        gtc = np.maximum(gt, 0)
        rs_present = rs_selected = None
        if self._dbsnp_ctg is not None:
            rs_present, rs_selected = self._dbsnp_ctg.range_flags(x, y)
        skip_homref = GT_FLAG_A[gtc, rfix] & (not self.cfg.all_positions)
        if rs_selected is not None:
            # maf-selected dbSNP sites force emission (print_vcf.c:139)
            skip_homref &= ~rs_selected
        skip_len = pos > ctg.seq_len
        emit = reach & ~skip_homref & ~skip_len
        idx = np.nonzero(emit)[0]
        if len(idx) == 0 and not (self.stats is not None and reach.any()):
            return

        counts = soa["counts"][idx]
        quals = soa["quals"][idx]
        gt_prob = soa["gt_prob"][idx]
        g = gtc[idx]
        r = rfix[idx]
        mq = soa["mq"][idx]
        fs = soa["fs"][idx]
        n = len(idx)

        g1 = g5[idx, 1]
        g2 = g5[idx, 2]
        g3 = g5[idx, 3]
        prep = _native_emit_prep(
            n, counts, gt_prob, g, r, mq, fs, g1, g2, g3
        )
        if prep is not None:
            (phred, dp1, qd, fs_int, flt, mac1, gl_vals, gl_len,
             cg_code, cond_cg, het_arr) = prep
            c = counts
        else:
            het_arr = None
            # phred (print_vcf.c:140-148): the vectorized libm-rescue
            # implementation is shared with the stats path
            from bs_call_tpu.ops.postprocess import phred_scores

            phred = phred_scores(gt_prob, g).astype(np.int64)

            dp1 = counts[:, :4].sum(axis=1)
            fs_int = np.trunc(-fs * 10.0 + 0.5).astype(np.int64)
            qd = np.where(dp1 > 0, phred // np.maximum(dp1, 1), phred)
            flt = (
                (phred < 20).astype(np.int64)
                | ((qd < 2).astype(np.int64) << 1)
                | ((fs_int > 60).astype(np.int64) << 2)
                | ((mq < 40).astype(np.int64) << 3)
            )
            # mac1 (print_vcf.c:192-212; shared table in postprocess)
            from bs_call_tpu.ops.postprocess import MAC_CATS

            c = counts
            mac1 = np.zeros(n, dtype=bool)
            for gv, (sa, sb) in MAC_CATS.items():
                m = g == gv
                if m.any():
                    mac1[m] = (c[m][:, list(sa)].sum(axis=1) <= 1) | (
                        c[m][:, list(sb)].sum(axis=1) <= 1
                    )
            mac1 &= flt == 0

            # GL values (float32-rounded for %g formatting)
            gl_idx = GL_IDX[g, r]  # [n, 5]
            gl_len = GL_LEN[g, r]
            safe = np.maximum(gl_idx, 0)
            gl_vals = gt_prob[np.arange(n)[:, None], safe]
            gl_vals = np.maximum(gl_vals, -99.999)
            gl_vals = np.where(gl_idx == -2, -99.999, gl_vals)
            gl_vals = gl_vals.astype(np.float32)

            # CpG status automaton (print_vcf.c:227-266), vectorized
            g1c = np.maximum(g1 - 1, 0)
            g3c = np.maximum(g3 - 1, 0)

            def hn(neigh, neigh_flag):
                return np.where(
                    neigh > 0, np.where(neigh_flag, 72, 78), 63
                )  # 'H','N','?'

            cond_cg = ((g2 == 5) & (g3 == 8)) | ((g2 == 8) & (g1 == 5))
            cond_c = g2 == 5
            cond_g = g2 == 8
            cond_cf = CFLAG_A[g]
            cond_gf = GFLAG_A[g]
            branch_c = hn(g3, GFLAG_A[g3c])
            branch_g = hn(g1, CFLAG_A[g1c])
            branch_gf = np.where(
                g1 > 0, np.where(CFLAG_A[g1c], 72, 78), ord(".")
            )
            # 'CG' is two chars; cond_cg rows override the code below
            cg_code = np.select(
                [cond_cg, cond_c, cond_g, cond_cf, cond_gf],
                [ord("G"), branch_c, branch_g, branch_c, branch_gf],
                ord("."),
            )

        # context strings
        # kept as bytes end to end: the native formatters take them
        # verbatim and a decode/encode round-trip of 10n chars per block
        # was measurable in the emit stage
        prf_all = PBASE_B[rf7[idx, :5]].tobytes()
        ctx_all = IUPAC_B[g5[idx]].tobytes()

        pos_e = pos[idx]
        het = het_arr if het_arr is not None else GT_HET_A[g]
        # rs IDs for emitted rows
        rs_ids = None
        if rs_present is not None:
            rs_ids = [None] * n
            for i in np.nonzero(rs_present[idx])[0]:
                _, rs_ids[i] = self._dbsnp_ctg.lookup(int(pos_e[i]))

        if self.stats is not None:
            self._accumulate_stats(
                ctg, soa, pos, reach, idx, g, r, rf7, phred, qd, fs_int,
                mq, flt, mac1, counts, cond_cg, rs_present, rs_selected,
            )

        q8 = quals
        if self._bcf is not None:
            if n:
                ok = _native_format_bcf(
                    self._bcf, ctg, n, g, r, flt, mac1, prf_all, ctx_all,
                    phred, dp1, mq, qd, gl_vals, gl_len, c, q8, cond_cg,
                    cg_code, het, fs_int, pos_e, rs_ids,
                )
                if not ok:
                    raise RuntimeError("native BCF formatter unavailable")
            return
        if n and _native_format(
            self._f, ctg, n, g, r, flt, mac1, prf_all, ctx_all, phred,
            dp1, mq, qd, gl_vals, gl_len, c, q8, cond_cg, cg_code, het,
            fs_int, pos_e, rs_ids,
        ):
            return
        lines = self._format_rows(
            ctg, n, g, r, flt, mac1, prf_all, ctx_all, phred, dp1, mq, qd,
            gl_vals, gl_len, c, q8, cond_cg, cg_code, het, fs_int, pos_e,
            rs_ids,
        )
        self._f.write("".join(lines).encode())

    def _format_rows(
        self, ctg, n, g, r, flt, mac1, prf_all, ctx_all, phred, dp1, mq,
        qd, gl_vals, gl_len, c, q8, cond_cg, cg_code, het, fs_int, pos_e,
        rs_ids,
    ):
        name = ctg.name
        lines = []
        for i in range(n):
            gi = g[i]
            ri = r[i]
            f = int(flt[i])
            if f:
                filt = "fail"
                ft = FT_STR[f & 15]
            elif mac1[i]:
                filt = "mac1"
                ft = "PASS"
            else:
                filt = "PASS"
                ft = "PASS"
            prf = prf_all[i * 5 : i * 5 + 5].decode()
            ctx = ctx_all[i * 5 : i * 5 + 5].decode()
            ph = phred[i]
            gl = ",".join(
                "%g" % gl_vals[i, k] for k in range(gl_len[i])
            )
            ci = c[i]
            mc8 = "%d,%d,%d,%d,%d,%d,%d,%d" % tuple(ci)
            amq = ",".join(str(q8[i, k]) for k in range(8) if ci[k] > 0)
            if cond_cg[i]:
                cgs = "C"  # reference emits one char (print_vcf.c:366)
            else:
                cgs = chr(cg_code[i])
            fmt = "GT:FT:DP:MQ:GQ:QD:GL:MC8:AMQ:CS:CG:CX"
            vals = (
                f"{GT_STR[gi][ri]}:{ft}:{dp1[i]}:{mq[i]}:{ph}:{qd[i]}:"
                f"{gl}:{mc8}:{amq}:{CS_STR[gi]}:{cgs}:{ctx}"
            )
            if het[i]:
                fmt += ":FS"
                vals += f":{fs_int[i]}"
            rid = rs_ids[i] if rs_ids is not None and rs_ids[i] else "."
            lines.append(
                f"{name}\t{pos_e[i]}\t{rid}\t{PBASE[ri]}\t{ALT_STR[gi][ri]}\t"
                f"{ph}\t{filt}\tCX={prf}\t{fmt}\t{vals}\n"
            )
        return lines

    def _accumulate_stats(
        self, ctg, soa, pos, reach, idx, g, r, rf7, phred, qd, fs_int,
        mq, flt, mac1, counts, cond_cg, rs_present, rs_selected,
    ):
        """Stats block of _print_vcf_entry (print_vcf.c:382-526): one
        native C++ pass when available (stats/native_acc.py), else the
        vectorized numpy transcription below (also forced by
        BS_CALL_PY_STATS=1, the parity-test switch)."""
        if not self._nacc_tried:
            self._nacc_tried = True
            from bs_call_tpu.stats.native_acc import NativeStatsAcc

            self._nacc = NativeStatsAcc.create(
                quirks=self.cfg.reference_quirks
            )
        if self._nacc is not None:
            self._nacc.accumulate(
                self, ctg, soa, pos, reach, idx, g, r, rf7, phred, qd,
                fs_int, mq, flt, mac1, counts, cond_cg, rs_present,
            )
            return
        stats = self.stats
        ctg_stats = ctg.ctg_stats
        all_counts = soa["counts"]
        dp_all = all_counts.sum(axis=1).astype(np.int64)
        # coverage hash + GC% for every reached (covered, deduped) row
        ri_ = np.nonzero(reach)[0]
        gc_bins = ctg_stats.gc if ctg_stats is not None else None
        gc_start = getattr(ctg, "gc_start_pos", 1)
        if len(ri_):
            dpr = dp_all[ri_]
            if gc_bins is not None and len(gc_bins):
                bn = (pos[ri_] - gc_start) // 100
                ok = (bn >= 0) & (bn < len(gc_bins))
                gc = np.where(ok, gc_bins[np.clip(bn, 0, len(gc_bins) - 1)],
                              255)
                ok &= gc <= 100
            else:
                ok = np.zeros(len(ri_), dtype=bool)
                gc = np.zeros(len(ri_), dtype=np.int64)
            uniq, inv = np.unique(dpr, return_inverse=True)
            cnts = np.bincount(inv)
            for k, d in enumerate(uniq):
                stats.cov_stats[int(d)].all += int(cnts[k])
            sel = np.nonzero(ok)[0]
            if len(sel):
                key = dpr[sel] * 102 + gc[sel]
                uk, kc = np.unique(key, return_counts=True)
                for k, cnt in zip(uk, kc):
                    stats.cov_stats[int(k // 102)].gc_pcent[
                        int(k % 102)
                    ] += int(cnt)
        n = len(idx)
        if n == 0:
            return
        dp1 = counts[:, :4].sum(axis=1).astype(np.int64)
        d_inf = counts[:, 4:].sum(axis=1).astype(np.int64)
        dp = dp1 + d_inf
        het = GT_HET_A[g]
        flt_full = flt | np.where(mac1, 128, 0)
        vg, mg_ = variant_gate_luts(self.cfg.reference_quirks)
        is_var = vg[g, r]
        is_multi = mg_[g, r] & is_var
        is_snp = is_var & ~is_multi
        passed = flt_full == 0

        def bump(target, mask):
            target[0] += int(mask.sum())
            target[1] += int((mask & passed).sum())

        bump(stats.snps, is_snp)
        bump(stats.multi, is_multi)
        if ctg_stats is not None:
            bump(ctg_stats.snps, is_snp)
            bump(ctg_stats.multi, is_multi)
        stats.qual[1] += np.bincount(
            phred[is_var], minlength=256
        ).astype(np.int64)
        # per-coverage variant counts
        for d, cnt in zip(*np.unique(dp[is_var], return_counts=True)):
            stats.cov_stats[int(d)].var += int(cnt)
        # QC distributions: qd/mq are bounded (<=255) -> one bincount
        # each; fs is unbounded -> unique
        for dct, vals, bounded in (
            (stats.qd_stats, qd, True),
            (stats.fs_stats, fs_int, False),
            (stats.mq_stats, mq, True),
        ):
            key = vals.astype(np.int64) * 2 + het
            if bounded:
                bc = np.bincount(key)
                for k in np.nonzero(bc)[0]:
                    dct[int(k) // 2][int(k) % 2] += int(bc[k])
            else:
                for k, cnt in zip(*np.unique(key, return_counts=True)):
                    dct[int(k) // 2][int(k) % 2] += int(cnt)
        key = het.astype(np.int64) * 32 + (flt_full & 31)
        bc = np.bincount(key, minlength=64)
        for k in np.nonzero(bc)[0]:
            stats.filter_counts[int(k) // 32][int(k) % 32] += int(bc[k])
        stats.qual[0] += np.bincount(phred, minlength=256).astype(np.int64)
        if rs_present is not None:
            rsp = rs_present[idx]
            bump(stats.dbSNP_sites, rsp)
            bump(stats.dbSNP_var, rsp & is_var)
            if ctg_stats is not None:
                bump(ctg_stats.dbSNP_sites, rsp)
                bump(ctg_stats.dbSNP_var, rsp & is_var)
        else:
            rsp = np.zeros(n, dtype=bool)
        # ---- CpG pair + methylation posterior block ----
        # CS '+' genotypes: indices where CS_STR == '+': {1,4,6}; '-': {2,7,8}
        plus = cond_cg & np.isin(g, [1, 4, 6])
        minus = cond_cg & np.isin(g, [2, 7, 8])
        pos_e = pos[idx]
        ref_cpg_plus = (rf7[idx, 2] == 2) & (rf7[idx, 3] == 3)
        ref_cpg_minus = (rf7[idx, 1] == 2) & (rf7[idx, 2] == 3)
        # last '+'-CG row before each row (carry-in across blocks)
        plus_idx = np.where(plus, np.arange(n), -1)
        last_plus = np.maximum.accumulate(plus_idx)
        prev_x = np.where(
            last_plus >= 0, pos_e[np.maximum(last_plus, 0)],
            self.prev_cpg_x,
        )
        prev_flt = np.where(
            last_plus >= 0,
            flt_full[np.maximum(last_plus, 0)] != 0,
            self.prev_cpg_flt,
        )
        # for a minus row, its own last_plus excludes itself (plus/minus
        # disjoint), but the accumulate INCLUDES the current row for plus
        # rows — harmless since only minus rows consume prev_x
        pair = minus & (pos_e - prev_x == 1)
        pair_flt = prev_flt | (flt_full != 0)
        for mask, key in (
            (pair & ref_cpg_minus, "CpG_ref"),
            (pair & ~ref_cpg_minus, "CpG_nonref"),
        ):
            getattr(stats, key)[0] += int(mask.sum())
            getattr(stats, key)[1] += int((mask & ~pair_flt).sum())
            if ctg_stats is not None:
                getattr(ctg_stats, key)[0] += int(mask.sum())
                getattr(ctg_stats, key)[1] += int(
                    (mask & ~pair_flt).sum()
                )
        if plus.any():
            last = int(np.nonzero(plus)[0][-1])
            self.prev_cpg_x = int(pos_e[last])
            self.prev_cpg_flt = bool(flt_full[last] != 0)
        cpg_ok = plus | minus
        ref_cpg = np.where(plus, ref_cpg_plus, ref_cpg_minus)
        a = np.where(plus, counts[:, 5], counts[:, 6]).astype(np.int64)
        b = np.where(plus, counts[:, 7], counts[:, 4]).astype(np.int64)
        for m, q_row in (
            (cpg_ok & ref_cpg, 2),
            (cpg_ok & ~ref_cpg, 3),
        ):
            stats.qual[q_row] += np.bincount(
                phred[m], minlength=256
            ).astype(np.int64)
        for m, which in ((cpg_ok & ref_cpg, 0), (cpg_ok & ~ref_cpg, 1)):
            for d, cnt in zip(*np.unique(dp[m], return_counts=True)):
                stats.cov_stats[int(d)].CpG[which] += int(cnt)
            for d, cnt in zip(*np.unique(d_inf[m], return_counts=True)):
                stats.cov_stats[int(d)].CpG_inf[which] += int(cnt)
        mm = np.nonzero(cpg_ok & (a + b > 0))[0]
        if len(mm):
            am, bm = a[mm].astype(np.float64), b[mm].astype(np.float64)
            konst = (
                _lfact_vec(a[mm] + b[mm] + 1)
                - _lfact_vec(a[mm])
                - _lfact_vec(b[mm])
            )
            meth = np.zeros((len(mm), 101))
            meth[:, 0] = np.where(a[mm] == 0, np.exp(konst), 0.0)
            meth[:, 100] = np.where(b[mm] == 0, np.exp(konst), 0.0)
            mid = konst[:, None] + _LOGP[None, :99] * am[:, None]
            mid = mid + _LOGP[None, :99][:, ::-1] * bm[:, None]
            meth[:, 1:100] = np.exp(mid)
            s = meth.sum(axis=1)
            z = meth / s[:, None]
            for which, grid in ((True, stats.CpG_ref_meth),
                                (False, stats.CpG_nonref_meth)):
                rows = ref_cpg[mm] == which
                if rows.any():
                    grid[0] += z[rows].sum(axis=0)
                    ok_rows = rows & (flt_full[mm] == 0)
                    if ok_rows.any():
                        grid[1] += z[ok_rows].sum(axis=0)
        # mutation spectrum
        mut = MUT_A[g, r]
        mv = mut != 12
        for arr, cond in (
            (stats.mut_counts, mv),
            (stats.dbSNP_mut_counts, mv & rsp),
        ):
            bc = np.bincount(mut[cond], minlength=13)
            pc = np.bincount(mut[cond & passed], minlength=13)
            for k in range(12):
                if bc[k]:
                    arr[k][0] += int(bc[k])
                if pc[k]:
                    arr[k][1] += int(pc[k])
