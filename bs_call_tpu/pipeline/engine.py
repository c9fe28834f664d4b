"""Calling engine: batches pileup positions through the genotype model and
applies the float64 libm rescue for boundary cases.

Engines: on the host, the native C++ float64 model (ops/genotype_native.py)
is the default exact engine, with the XLA float64 kernel and the NumPy
twin as fallbacks. On a GPU, exact mode runs the fused tier — the read
batch crosses H2D once and pileup + aggregation + the float64 model run
in one compiled program (ops/kernels/pileup_device.py) — or the float64
column kernel (ops/genotype.py); --no-exact runs the float32 column
kernel.
Positions whose top-2 log-likelihood margin is below 1e-9 — where a
libm-ulp difference between engines could flip the argmax — are recomputed
with the scalar float64 oracle, which uses the same libm as the C
reference, so exact-mode output bytes do not depend on which engine ran.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import List, Optional

import numpy as np

from bs_call_tpu.config import CallerConfig
from bs_call_tpu.constants import LOG10
from bs_call_tpu.ops import oracle
from bs_call_tpu.ops.postprocess import aggregate_pileup, fisher_strand
from bs_call_tpu.output.site import SiteCall


_UNSET = object()


def _pinned_to_cpu() -> bool:
    """True when the JAX platform list names only cpu (decided without
    importing jax or initializing a backend)."""
    jm = sys.modules.get("jax")
    plats = (
        jm.config.jax_platforms if jm is not None
        else os.environ.get("JAX_PLATFORMS", "")
    )
    names = [p.strip() for p in str(plats or "").split(",") if p.strip()]
    return bool(names) and all(p == "cpu" for p in names)


def _ms(t: float) -> str:
    return f"{1e3 * t:.1f}ms"


class CallEngine:
    """Maps (counts2, qual_sum, mapq2_sum, ref) blocks to per-position
    SiteCall results.

    `device` is the jax.Device the device tier runs on. With
    cfg.device == "gpu" it defaults to the first GPU (NoGpuError when
    there is none); tests hand in a CPU device to drive the same tier.
    With cfg.device == "auto" the engine looks for a GPU itself, in
    process, and races the fused tier against the host f64 engine."""

    # positions of host-f64 work before device=auto races the fused tier
    # on one warm real chunk
    RACE_AFTER = 2_000_000

    def __init__(self, cfg: CallerConfig, device=None):
        self.cfg = cfg
        self._params = None
        self._jax_state = _UNSET  # lazily imported, see _jax
        self._device = _UNSET if device is None else device
        self._prefer_xla = None  # virtual-mesh f64 preference (cached)
        self._sharded = {}  # (kind, platform) -> (mesh, jitted fn) | None
        self._exact_engine = None  # auto: "f64" | "fused" after the race
        self._chunk_pool = None  # chunk-dispatch thread pool (lazy)
        self._fused_fns = {}  # n_pos -> (mesh | None, fn)
        self._fused_pos = 0  # positions seen with reads (race gating)
        self.tracer = None  # set by the runner for -v observability
        if cfg.device == "gpu" or device is not None or not cfg.exact:
            if self._jax is None:
                raise RuntimeError("bs_call: the JAX engines need jax")
        if cfg.device == "gpu" and device is None:
            from bs_call_tpu.utils import gpu_device

            self._device = gpu_device()

    @property
    def _jax(self):
        """(jax, jnp, call_genotypes) or None — imported on FIRST USE:
        the default exact path is the native C++ host kernel, so a
        cpu-pinned process (shard workers, report-only reruns) never pays
        the jax import or backend init at all. The import also switches
        on float64 (utils.configure_jax) before anything is traced."""
        if self._jax_state is _UNSET:
            self._jax_state = None
            if self.cfg.device != "numpy":
                try:
                    from bs_call_tpu.utils import configure_jax

                    jax = configure_jax()
                    import jax.numpy as jnp

                    from bs_call_tpu.ops.genotype import (
                        ModelParams,
                        call_genotypes,
                    )
                except ImportError:
                    return None
                self._params = ModelParams(
                    under_conv=self.cfg.under_conv,
                    over_conv=self.cfg.over_conv,
                    ref_bias=self.cfg.ref_bias,
                )
                self._jax_state = (jax, jnp, call_genotypes)
        return self._jax_state

    def _tier_device(self):
        """The jax.Device of the device tier, or None (host engines
        only). device=auto takes the default backend's first device when
        it is a GPU; a cpu-pinned process never initializes another
        backend."""
        if self._device is _UNSET:
            self._device = None
            if (
                self.cfg.device == "auto"
                and not _pinned_to_cpu()
                and self._jax is not None
            ):
                dev = self._jax[0].devices()[0]
                if dev.platform == "gpu":
                    self._device = dev
        return self._device

    # ------------------------------------------------------------------

    def _call_batch(self, counts, quals, ref):
        """Column batch call. Returns (gt_prob [N,10] f64, max_gt [N],
        margin [N] f64, off_sum [N] f64).

        gt_prob's argmax entry is set C-style to -log(1+off)/LOG10 (f64,
        with the 1+off absorption the reference's double arithmetic has,
        genotype_model.c:240-244), so the emitter's phred chain reproduces
        the reference's GQ quantization exactly.
        """
        from bs_call_tpu.ops.genotype_np import call_genotypes_np

        n = len(ref)
        if n == 0:
            return (
                np.zeros((0, 10)),
                np.zeros(0, np.int32),
                np.zeros(0),
                np.zeros(0),
            )
        if self.cfg.exact or self._jax is None:
            # Exact mode needs float64 likelihoods (printed GL fields
            # carry ~6 significant digits; a plain f32 result has ~1e-4
            # relative ll error): the f64 kernel on the GPU under
            # device=gpu, else the host engines.
            res = None
            if self.cfg.device == "gpu":
                res = self._chunked_call(
                    counts, quals, ref, self._jax[1].float64,
                    self._tier_device(),
                )
            elif self._prefer_xla_f64():
                res = self._call_f64_cpu(counts, quals, ref)
            if res is None:
                res = self._call_host_f64(counts, quals, ref)
            if res is None:
                res = call_genotypes_np(
                    counts, quals, ref,
                    self.cfg.under_conv, self.cfg.over_conv,
                    self.cfg.ref_bias,
                )
        else:
            jax, jnp, _ = self._jax
            res = self._chunked_call(
                counts, quals, ref, jnp.float32,
                self._tier_device() or jax.devices("cpu")[0],
            )
        return self._finish_exact(*res, counts, quals, ref)

    def _finish_exact(self, gt_prob, max_gt, margin, off, counts, quals,
                      ref):
        """C-style max-entry replacement (absorbing 1+off) so the GQ
        phred chain reproduces the reference's double-precision
        quantization, plus (exact mode) the scalar-oracle rescue of true
        ties / libm-ulp boundaries (same libm as the C binary); the
        oracle's gt_prob is already C-style."""
        idx = np.arange(len(max_gt))
        gt_prob[idx, max_gt] = -np.log(1.0 + off) / LOG10
        if self.cfg.exact:
            ties = margin < 1e-9
            for j in np.nonzero(ties)[0]:
                gt_prob[j], max_gt[j] = oracle.calc_gt_prob(
                    counts[j], quals[j], int(ref[j]),
                    self.cfg.under_conv, self.cfg.over_conv,
                    self.cfg.ref_bias,
                )
        return gt_prob, max_gt, margin, off

    # ------------------------------------------------------------------
    # Fused device tier: the normalized read batch crosses H2D once and
    # pileup + aggregation + the f64 model run in ONE compiled program
    # (ops/kernels/pileup_device.py) — the device replacement of the
    # reference's pileup + calc_gt_prob hot loops
    # (call_genotypes.c:180-226). Exactness contract: device quals are
    # shipped back (uint8) and compared against the host C++ aggregate;
    # any f32-boundary mismatch — and every ll tie — rescues through the
    # oracle, so output bytes are identical to the host engines
    # regardless of device float behavior.

    # extra padded positions beyond batch_positions: runner tail chunks
    # carry up to 16 overlap rows; 64 keeps the padded width divisible
    # by any power-of-two mesh up to 64 devices
    _FUSED_PAD = 64

    def wants_reads(self) -> bool:
        """Should the runner export per-block read batches? True when
        the fused tier could engage: exact mode and either device=gpu
        or device=auto with a GPU (until the race picks f64)."""
        cfg = self.cfg
        if not cfg.exact or cfg.device not in ("gpu", "auto"):
            return False
        if self._exact_engine is not None:
            return self._exact_engine == "fused"
        return self._tier_device() is not None

    def _fused_fn(self, n_pos: int):
        """(mesh | None, fn) for one padded width: position-sharded over
        every device of the tier's platform when there are >1 usable
        (reads data-parallel + one psum, sharding.py design), else one
        program placed by its inputs. fn returns the model outputs plus
        the device quals."""
        hit = self._fused_fns.get(n_pos)
        if hit is not None:
            return hit
        from bs_call_tpu.ops.kernels import pileup_device
        from bs_call_tpu.parallel.sharding import usable_device_count

        jax = self._jax[0]
        devs = jax.devices(self._tier_device().platform)
        nd = usable_device_count(len(devs), n_pos)
        mesh = None
        if nd >= 2 and self.cfg.use_mesh:
            from jax.sharding import Mesh

            mesh = Mesh(np.array(devs[:nd]), ("pos",))
            fn = pileup_device.sharded_fused_ll_f64(
                mesh, self._params, n_pos, self.cfg.min_qual
            )
        else:
            fn = functools.partial(
                pileup_device.fused_ll_f64, n_pos=n_pos,
                min_qual=self.cfg.min_qual, params=self._params,
            )
        self._fused_fns[n_pos] = (mesh, fn)
        self._trace_decision(
            f"fused tier: {nd if mesh is not None else 1} "
            f"{devs[0].platform} device(s), n_pos {n_pos}"
        )
        return mesh, fn

    @staticmethod
    def _pow2(n: int, lo: int) -> int:
        p = lo
        while p < n:
            p *= 2
        return p

    def _call_fused(self, reads: dict, lo: int, hi: int, ref_codes,
                    agg, covered_idx):
        """Fused-tier chunk call over block-relative window [lo, hi].
        Returns (gt_prob, max_gt, margin, off, n_rescued) for the covered
        subset (pre-absorption; the n_rescued rows whose device quals
        differ from the host aggregate carry margin=0 so _finish_exact's
        oracle rescue recomputes them from host inputs), or None when
        the chunk does not fit the tier's shapes (the caller then runs
        the column engines). Raises RuntimeError when the device quals
        differ on more than 1% of the rows: that is a device fault, not
        an f32 boundary case."""
        sz = hi - lo + 1
        # runner chunk width is max(batch_positions, 1024) (+16 overlap
        # on tail chunks) — runner.py CHUNK
        n_pos = max(self.cfg.batch_positions, 1024) + self._FUSED_PAD
        L = reads["rd"].shape[1]
        if sz > n_pos or L > 2048:
            return None
        from bs_call_tpu.ops.kernels.pileup_device import pad_read_batch

        l_cap = self._pow2(L, 64)
        starts = reads["starts"]
        n_rows = int(
            ((starts <= hi) & (starts + reads["lens"] - 1 >= lo)).sum()
        )
        # each (n_pos, r_pad, l_cap) compiles its own program; powers of
        # two keep the set small
        r_pad = self._pow2(max(n_rows, 1), 1024)
        padded = pad_read_batch(reads, lo, hi, r_pad, l_cap)
        ref_pad = np.zeros(n_pos, np.int32)
        ref_pad[:sz] = np.asarray(ref_codes, dtype=np.int32)
        mesh, fn = self._fused_fn(n_pos)
        if mesh is not None:
            from bs_call_tpu.parallel.sharding import shard_positions

            args = shard_positions(mesh, *padded, ref_pad)
        else:
            args = self._jax[0].device_put(
                (*padded, ref_pad), self._tier_device()
            )
        gt_prob, max_gt, margin, off, dev_q = (
            np.asarray(a)[covered_idx] for a in fn(*args)
        )
        dev_q = dev_q.astype(np.int32)
        host_q = agg["quals"][covered_idx]
        mism = (dev_q != host_q).any(axis=1)
        n_mism = int(mism.sum())
        if n_mism > max(16, len(covered_idx) // 100):
            raise RuntimeError(
                f"fused tier: device quals differ from the host pileup "
                f"on {n_mism} of {len(covered_idx)} positions"
            )
        if n_mism:
            margin = margin.copy()
            margin[mism] = 0.0  # forces the oracle rescue
        return gt_prob, max_gt, margin, off, n_mism

    def _fused_gate(self, reads, lo, hi, ref_codes, agg, covered_idx):
        """Decide whether this chunk runs the fused tier. device=gpu
        forces it; device=auto with a GPU races one warm real chunk
        through fused vs the f64 host engine after RACE_AFTER positions
        (never changing output bytes — both land below the oracle tie
        threshold)."""
        cfg = self.cfg
        if not cfg.exact:
            return False
        if cfg.device == "gpu":
            return True
        if cfg.device != "auto" or self._tier_device() is None:
            return False
        if self._exact_engine is not None:
            return self._exact_engine == "fused"
        self._fused_pos += len(covered_idx)
        if self._fused_pos < self.RACE_AFTER:
            return False

        def clock(fn):
            if fn() is None:  # warm (compiles); None: the tier declined
                return float("inf")
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        counts = agg["counts"][covered_idx].astype(np.int32)
        quals = agg["quals"][covered_idx]
        cref = np.asarray(ref_codes, dtype=np.int32)[covered_idx]
        t_f64 = clock(lambda: self._call_host_f64(counts, quals, cref))
        t_fused = clock(
            lambda: self._call_fused(
                reads, lo, hi, ref_codes, agg, covered_idx
            )
        )
        self._exact_engine = "fused" if t_fused < 0.8 * t_f64 else "f64"
        self._trace_decision(
            f"exact engine: {self._exact_engine} (fused {_ms(t_fused)} "
            f"vs f64 {_ms(t_f64)} on one {len(covered_idx)}-position "
            "chunk)"
        )
        return self._exact_engine == "fused"

    def _mesh_kernel(self, kind, platform):
        """(mesh, jitted sharded kernel) over the platform's devices, or
        None when it exposes <2 usable devices. kind: 'f32' | 'f64'.

        This is the production multi-device path: whenever the platform
        has several devices (GPUs, or the virtual CPU mesh in tests),
        the fixed-shape chunk is position-sharded over them with
        shard_map. The model is a pure per-position map, so sharded
        outputs are bitwise equal to the single-device kernel and the
        exactness tiers are untouched."""
        key = (kind, platform)
        if key in self._sharded:
            return self._sharded[key]
        jax, jnp, _ = self._jax
        devs = jax.devices(platform)
        from bs_call_tpu.parallel.sharding import (
            sharded_call_genotypes,
            usable_device_count,
        )

        res = None
        nd = usable_device_count(len(devs), self.cfg.batch_positions)
        if nd >= 2 and self.cfg.use_mesh:
            from jax.sharding import Mesh

            mesh = Mesh(np.array(devs[:nd]), ("pos",))
            dtype = jnp.float64 if kind == "f64" else jnp.float32
            res = (mesh, sharded_call_genotypes(mesh, self._params, dtype))
        self._sharded[key] = res
        return res

    def _trace_decision(self, msg: str) -> None:
        t = getattr(self, "tracer", None)
        if t is not None:
            t.progress(msg)

    def _count(self, name: str, n: int = 1) -> None:
        t = getattr(self, "tracer", None)
        if t is not None:
            t.count(name, n)

    def _pipe_chunks(self, counts, quals, ref, dispatch, finish,
                     window: int = 3):
        """Chunked engine driver with device pipelining: up to `window`
        chunks are in flight, dispatched from a small thread pool —
        JAX's async dispatch overlaps H2D/compute/D2H on accelerators,
        and on the CPU backend two concurrently-executing chunk programs
        use ~1.6x the cores one does (XLA:CPU does not fully parallelize
        this elementwise graph internally). In-order drain; fixed chunk
        shape = one compiled executable."""
        bp = self.cfg.batch_positions
        n = len(ref)
        gt_prob = np.empty((n, 10), dtype=np.float64)
        max_gt = np.empty(n, dtype=np.int32)
        margin = np.empty(n, dtype=np.float64)
        off = np.empty(n, dtype=np.float64)
        from collections import deque

        if self._chunk_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._chunk_pool = ThreadPoolExecutor(max_workers=2)
        pool = self._chunk_pool
        inflight = deque()

        def drain():
            s, e, fut = inflight.popleft()
            gp, mg, mr, of = finish(fut.result())
            m = e - s
            gt_prob[s:e] = gp[:m]
            max_gt[s:e] = mg[:m]
            margin[s:e] = mr[:m]
            off[s:e] = of[:m]

        for s in range(0, n, bp):
            e = min(s + bp, n)
            ck, qk, rk = counts[s:e], quals[s:e], ref[s:e]
            pad = bp - (e - s)
            if pad:
                ck = np.concatenate([ck, np.zeros((pad, 8), ck.dtype)])
                qk = np.concatenate([qk, np.zeros((pad, 8), qk.dtype)])
                rk = np.concatenate([rk, np.zeros(pad, rk.dtype)])
            inflight.append((s, e, pool.submit(dispatch, ck, qk, rk)))
            if len(inflight) >= window:
                drain()
        while inflight:
            drain()
        return gt_prob, max_gt, margin, off

    def _chunked_call(self, counts, quals, ref, dtype, device):
        """Run the jitted kernel on `device` over fixed-size chunks so
        exactly one shape is ever compiled per dtype; chunks are
        position-sharded over the platform's device mesh when it has
        more than one device."""
        jax, jnp, call_genotypes = self._jax
        kind = "f64" if dtype == jnp.float64 else "f32"
        sharded = self._mesh_kernel(kind, device.platform)
        if sharded is not None:
            from bs_call_tpu.parallel.sharding import shard_positions

            mesh, fn = sharded

            def dispatch(ck, qk, rk):
                # shard_positions pins placement explicitly, so this is
                # safe from the dispatch pool threads
                return fn(*shard_positions(mesh, ck, qk, rk))
        else:

            def dispatch(ck, qk, rk):
                # explicit placement: pool threads do not inherit the
                # caller's thread-local jax.default_device
                return call_genotypes(
                    *jax.device_put((ck, qk, rk), device), self._params,
                    dtype=dtype,
                )

        def finish(fut):
            return tuple(np.asarray(a) for a in fut)

        return self._pipe_chunks(counts, quals, ref, dispatch, finish)

    def _prefer_xla_f64(self) -> bool:
        """True only on a single-process multi-device CPU backend (the
        virtual test mesh, XLA_FLAGS=--xla_force_host_platform_device_
        count): there the XLA mesh f64 kernel IS the multi-device
        machinery being validated, so it outranks the native
        single-host kernel. Decided without importing jax (free False
        in jax-less shard workers) and only when the platform is pinned
        to cpu. Real hosts expose one CPU device, multi-host cpu
        backends expose remote devices — both get the native kernel."""
        if self._prefer_xla is None:
            self._prefer_xla = False
            if "jax" in sys.modules and _pinned_to_cpu():
                jm = sys.modules["jax"]
                devs = jm.devices("cpu")
                if len(jm.local_devices(backend="cpu")) == len(devs):
                    from bs_call_tpu.parallel.sharding import (
                        usable_device_count,
                    )

                    self._prefer_xla = usable_device_count(
                        len(devs), self.cfg.batch_positions
                    ) >= 2
        return self._prefer_xla

    def _call_native_f64(self, counts, quals, ref):
        """Batched float64 model in native C++/glibc-libm
        (bsc_model.cpp) — the default exact engine on the host: no jax
        import, no XLA compile, threads follow CPU affinity. Returns
        None when the native library is unavailable (then the XLA f64
        kernel or numpy twin carries the batch)."""
        try:
            from bs_call_tpu.ops.genotype_native import native_model

            m = native_model(
                self.cfg.under_conv, self.cfg.over_conv,
                self.cfg.ref_bias,
            )
        except Exception:
            return None
        if m is None:
            return None
        return m.call(counts, quals, ref)

    def _call_host_f64(self, counts, quals, ref):
        """The production host-side f64 engine: native kernel, XLA CPU
        fallback. This (not _call_f64_cpu) is what the device tier's
        race must beat."""
        res = self._call_native_f64(counts, quals, ref)
        if res is None:
            res = self._call_f64_cpu(counts, quals, ref)
        return res

    def _call_f64_cpu(self, counts, quals, ref):
        """Float64 batch on the host CPU backend (XLA-jitted); None if
        jax is unavailable."""
        if self._jax is None:
            return None
        jax, jnp, _ = self._jax
        return self._chunked_call(
            counts, quals, ref, jnp.float64, jax.devices("cpu")[0]
        )

    def call_block_soa(self, counts2, qual_sum, mapq2_sum, ref_codes,
                       agg=None, reads=None):
        """counts2 [sz,2,8], qual_sum [sz,8], mapq2_sum [sz],
        ref_codes [sz]. Returns a dict of position-major arrays:
        covered [sz] bool; counts [sz,8]; quals [sz,8]; mq, aq [sz];
        gt_prob [sz,10] f64; max_gt [sz]; fs [sz] f64.
        `agg` may carry natively precomputed aggregates. `reads`, when
        given, is (read_batch_dict, lo) with lo the block-relative
        offset of this window's first position — it enables the fused
        device tier (reads cross H2D instead of pileup columns)."""
        if agg is None:
            agg = aggregate_pileup(counts2, qual_sum, mapq2_sum)
        counts = agg["counts"]
        n = agg["n"]
        sz = len(n)
        covered_mask = n > 0
        covered = np.nonzero(covered_mask)[0]
        gt_prob_full = np.zeros((sz, 10), dtype=np.float64)
        max_gt_full = np.zeros(sz, dtype=np.int32)
        fs_full = np.zeros(sz, dtype=np.float64)
        if len(covered):
            ccounts = counts[covered]
            cquals = agg["quals"][covered]
            cref = np.asarray(ref_codes, dtype=np.int32)[covered]
            res = None
            if reads is not None:
                rd_dict, lo = reads
                hi = lo + sz - 1
                if self._fused_gate(
                    rd_dict, lo, hi, ref_codes, agg, covered
                ):
                    res = self._call_fused(
                        rd_dict, lo, hi, ref_codes, agg, covered
                    )
                    # -v counters: chunks the tier carried or declined
                    # (shape) and rows it left to the oracle rescue
                    if res is None:
                        self._count("fused_declined")
                    else:
                        *res, n_rescued = res
                        self._count("fused_chunks")
                        self._count("fused_rescued", n_rescued)
                        res = self._finish_exact(
                            *res, ccounts.astype(np.int32), cquals, cref,
                        )
            if res is None:
                res = self._call_batch(
                    ccounts.astype(np.int32), cquals, cref
                )
            gt_prob, max_gt, _margin, _off = res
            gt_prob_full[covered] = gt_prob
            max_gt_full[covered] = max_gt
            fs_full[covered] = fisher_strand(
                counts2[covered], max_gt, not self.cfg.reference_quirks,
            )
        soa = {
            "covered": covered_mask,
            "counts": counts,
            "quals": agg["quals"],
            "mq": agg["mq"],
            "aq": agg["aq"],
            "gt_prob": gt_prob_full,
            "max_gt": max_gt_full,
            "fs": fs_full,
        }
        return soa

    def call_block(self, counts2, qual_sum, mapq2_sum, ref_codes, agg=None):
        """Object view of call_block_soa for the scalar emitter path."""
        soa = self.call_block_soa(
            counts2, qual_sum, mapq2_sum, ref_codes, agg=agg
        )
        return soa_to_calls(soa)


def soa_to_calls(soa) -> List[Optional[SiteCall]]:
    """Materialize per-position SiteCall objects from a call_block_soa
    result (the scalar emitter's input shape)."""
    out: List[Optional[SiteCall]] = [None] * len(soa["covered"])
    for j in np.nonzero(soa["covered"])[0]:
        out[j] = SiteCall(
            counts=soa["counts"][j],
            quals=soa["quals"][j],
            gt_prob=soa["gt_prob"][j],
            fisher_strand=soa["fs"][j],
            mq=int(soa["mq"][j]),
            aq=int(soa["aq"][j]),
            max_gt=int(soa["max_gt"][j]),
        )
    return out
