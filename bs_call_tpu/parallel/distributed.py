"""Multi-host execution.

Topology: each host runs one bs_call_tpu process (jax.distributed).
Contigs are assigned to hosts by greedy LPT (the same
partitioner as the in-host shard runner); each host calls its contigs and
writes a per-host VCF with a uniform header (concat-compatible, the
reference's -s contract). The JSON stats block is then merged with device
collectives: every fixed-size counter flattens into one vector and a
single psum over the host axis produces the global stats; the
dynamically-keyed counters (coverage hash, fs/qd/mq, meth profile) are
all_gather'd as sparse tables and folded exactly on every host — no
fold bounds, matching the reference's unbounded hashes (stats.c:208-228).

Entry points:
  initialize(coordinator, num_processes, process_id) — jax.distributed
  my_contigs(universe, n_hosts, host_id) — deterministic assignment
  merge_stats_collective(stats, axis_devices) — psum-based global merge
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from bs_call_tpu.parallel.shard_runner import partition_contigs
from bs_call_tpu.stats.collect import BsStats


def initialize(
    coordinator: str, num_processes: int, process_id: int
) -> None:
    """jax.distributed bring-up (call once per host before any jax use)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def my_contigs(
    universe: List[Tuple[str, int]], n_hosts: int, host_id: int
) -> List[str]:
    """Deterministic contig assignment for this host."""
    shards = partition_contigs(universe, n_hosts)
    return shards[host_id] if host_id < len(shards) else []


# ---------------- collective stats merge ----------------

_FIXED_FIELDS = [
    ("snps", 2), ("indels", 2), ("multi", 2), ("dbSNP_sites", 2),
    ("dbSNP_var", 2), ("CpG_ref", 2), ("CpG_nonref", 2),
]
_ARRAY_FIELDS = [
    ("mut_counts", (12, 2)),
    ("dbSNP_mut_counts", (12, 2)),
    ("qual", (4, 256)),
    ("filter_cts", (15,)),
    ("filter_bases", (15,)),
    ("base_filter", (5,)),
    ("filter_counts", (2, 32)),
]
_FLOAT_FIELDS = [
    ("CpG_ref_meth", (2, 101)),
    ("CpG_nonref_meth", (2, 101)),
]
def stats_to_vectors(stats: BsStats) -> Dict[str, np.ndarray]:
    """Flatten the FIXED-shape part of a BsStats for psum. The
    dynamically-keyed parts (coverage hash, fs/qd/mq distributions,
    meth profile) travel as exact sparse tables instead —
    stats_to_sparse — because any dense fold would need a bound and the
    reference's hashes are unbounded (stats.c:208-228)."""
    ints = []
    for name, n in _FIXED_FIELDS:
        ints.extend(int(v) for v in getattr(stats, name))
    for name, shape in _ARRAY_FIELDS:
        ints.extend(np.asarray(getattr(stats, name)).ravel().tolist())
    iv = np.array(ints, dtype=np.int64)
    fv = np.concatenate(
        [np.asarray(getattr(stats, name)).ravel() for name, _ in _FLOAT_FIELDS]
    )
    return {"ints": iv, "floats": fv}


def stats_to_sparse(stats: BsStats) -> Dict[str, np.ndarray]:
    """The dynamically-keyed counters as [K, 1+C] int64 tables (column
    0 = key + 1, so an all-zero padding row can never alias a real
    entry), sorted by key for determinism."""
    cov_keys = sorted(int(d) for d in stats.cov_stats)
    cov = np.zeros((len(cov_keys), 1 + 6 + 101), dtype=np.int64)
    for i, d in enumerate(cov_keys):
        cs = stats.cov_stats[d]
        cov[i, 0] = d + 1
        cov[i, 1:7] = (
            cs.all, cs.var, cs.CpG[0], cs.CpG[1],
            cs.CpG_inf[0], cs.CpG_inf[1],
        )
        cov[i, 7:] = cs.gc_pcent
    out = {"cov": cov}
    for attr in ("fs_stats", "qd_stats", "mq_stats"):
        dct = getattr(stats, attr)
        keys = sorted(int(k) for k in dct)
        t = np.zeros((len(keys), 3), dtype=np.int64)
        for i, k in enumerate(keys):
            t[i] = (k + 1, dct[k][0], dct[k][1])
        out[attr] = t
    mp = np.asarray(stats.meth_profile, dtype=np.int64)
    mprof = np.zeros((len(mp), 5), dtype=np.int64)
    if len(mp):
        mprof[:, 0] = np.arange(1, len(mp) + 1)
        mprof[:, 1:] = mp
    out["mprof"] = mprof
    return out


def sparse_into_stats(stats: BsStats, tables: Dict[str, np.ndarray],
                      mprof_used: int) -> None:
    """Fold gathered sparse tables (leading axis = one slot per mesh
    device) into `stats`. Zero key columns are padding/empty slots."""
    cov = np.asarray(tables["cov"]).reshape(-1, 1 + 6 + 101)
    for row in cov:
        if row[0] == 0:
            continue
        cs = stats.cov_stats[int(row[0]) - 1]
        cs.all += int(row[1])
        cs.var += int(row[2])
        cs.CpG[0] += int(row[3])
        cs.CpG[1] += int(row[4])
        cs.CpG_inf[0] += int(row[5])
        cs.CpG_inf[1] += int(row[6])
        cs.gc_pcent = cs.gc_pcent + row[7:]
    for attr in ("fs_stats", "qd_stats", "mq_stats"):
        dct = getattr(stats, attr)
        for row in np.asarray(tables[attr]).reshape(-1, 3):
            if row[0] == 0:
                continue
            dct[int(row[0]) - 1][0] += int(row[1])
            dct[int(row[0]) - 1][1] += int(row[2])
    stats.grow_meth_profile(max(mprof_used, 0))
    for row in np.asarray(tables["mprof"]).reshape(-1, 5):
        idx = int(row[0]) - 1
        if idx < 0:
            continue
        if idx >= len(stats.meth_profile):
            stats.grow_meth_profile(idx)
        stats.meth_profile[idx] += row[1:]
    stats.meth_profile_used = mprof_used


def vectors_to_stats(v: Dict[str, np.ndarray]) -> BsStats:
    stats = BsStats()
    iv = np.asarray(v["ints"])
    off = 0
    for name, n in _FIXED_FIELDS:
        setattr(stats, name, [int(x) for x in iv[off : off + n]])
        off += n
    for name, shape in _ARRAY_FIELDS:
        size = int(np.prod(shape))
        setattr(
            stats, name, np.asarray(iv[off : off + size]).reshape(shape)
        )
        off += size
    fv = np.asarray(v["floats"])
    off = 0
    for name, shape in _FLOAT_FIELDS:
        size = int(np.prod(shape))
        setattr(stats, name, fv[off : off + size].reshape(shape))
        off += size
    return stats


def psum_arrays(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One psum over the 'hosts' axis for a dict of per-process arrays.

    Works both single-process (the axis spans the local devices; this
    process's payload sits on device 0, zeros elsewhere, so the psum is
    the identity) and multi-process after initialize() (each process
    contributes its payload on its first local device and the collective
    rides the jax.distributed transport — gloo on CPU)."""
    return _collective(vecs, gather=False)


def allgather_arrays(vecs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """all_gather counterpart of psum_arrays: returns each array with a
    new leading axis of one slot per mesh device (per host in a
    multi-process run; unused local slots are the zero payload the
    caller staged). The exact sparse-stats merge uses this: summing
    can't combine tables whose KEYS differ per host, gathering can."""
    return _collective(vecs, gather=True)


def _collective(
    vecs: Dict[str, np.ndarray], gather: bool
) -> Dict[str, np.ndarray]:
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from bs_call_tpu.utils import configure_jax

    # the merge runs on the CPU backend: the stats are host data, and
    # the payload's int64 counters and f64 grids need x64
    jax = configure_jax()
    devs = np.array(jax.devices("cpu"))
    n_local = len(jax.local_devices(backend="cpu"))
    mesh = Mesh(devs, ("hosts",))
    keys = sorted(vecs)
    args = []
    for k in keys:
        a = np.asarray(vecs[k])
        local = np.zeros((n_local,) + a.shape, dtype=a.dtype)
        local[0] = a
        sh = NamedSharding(mesh, P("hosts"))
        if jax.process_count() > 1:
            g = jax.make_array_from_process_local_data(sh, local)
        else:
            g = jax.device_put(local, sh)
        args.append(g)
    if gather:
        op = lambda a: jax.lax.all_gather(a[0], "hosts")  # noqa: E731
    else:
        op = lambda a: jax.lax.psum(a[0], "hosts")  # noqa: E731
    # check_vma=False: an all_gather result IS replicated across the
    # axis, but shard_map's varying-axes check cannot infer that
    fn = jax.jit(
        jax.shard_map(
            lambda *arrs: tuple(op(a) for a in arrs),
            mesh=mesh,
            in_specs=tuple(P("hosts") for _ in args),
            out_specs=tuple(P() for _ in args),
            check_vma=False,
        )
    )
    out = fn(*args)
    merged = {k: np.asarray(o) for k, o in zip(keys, out)}
    for k in keys:
        if merged[k].dtype != np.asarray(vecs[k]).dtype:
            raise AssertionError(
                f"collective changed dtype of {k}: "
                f"{np.asarray(vecs[k]).dtype} -> {merged[k].dtype}"
            )
    return merged


def merge_stats_collective(stats: BsStats, mesh=None) -> BsStats:
    """Merge per-host stats into the global stats with collectives over
    all participating processes/devices. On a single process this runs
    over the local device mesh; multi-host it runs over the global
    device set brought up by initialize().

    Fixed-shape counters merge with one psum. Dynamically-keyed tables
    (coverage hash, fs/qd/mq, meth profile) merge EXACTLY — the
    reference's hashes are unbounded (stats.c:208-228), so instead of
    clipping into dense bins, per-host sparse tables are padded to the
    globally largest row count (learned from one tiny all_gather) and
    all_gather'd; every host folds the identical union deterministically.

    (mesh is accepted for API compatibility and ignored: the axis always
    spans jax.devices().)"""
    sparse = stats_to_sparse(stats)
    names = sorted(sparse)
    sizes = np.array(
        [len(sparse[n]) for n in names] + [stats.meth_profile_used],
        dtype=np.int64,
    )
    g_sizes = np.asarray(
        allgather_arrays({"sizes": sizes})["sizes"]
    ).reshape(-1, len(sizes))
    kmax = g_sizes.max(axis=0)
    padded = {}
    for i, n in enumerate(names):
        t = sparse[n]
        k = max(int(kmax[i]), 1)
        p = np.zeros((k,) + t.shape[1:], dtype=np.int64)
        p[: len(t)] = t
        padded[n] = p
    gathered = allgather_arrays(padded)
    merged = vectors_to_stats(psum_arrays(stats_to_vectors(stats)))
    sparse_into_stats(merged, gathered, int(kmax[-1]))
    return merged


# ---------------- multi-host runtime ----------------


def _ctg_stats_matrix(universe, table) -> np.ndarray:
    """[n_contigs, 14] int64 of per-contig counters in universe order
    (zero rows for contigs this host did not call) — psum-able because
    each contig is owned by exactly one host."""
    by_name = {c.name: c.ctg_stats for c in table.contigs if c.ctg_stats}
    m = np.zeros((len(universe), 14), dtype=np.int64)
    for i, (name, _ln) in enumerate(universe):
        gs = by_name.get(name)
        if gs is None:
            continue
        m[i] = [
            gs.snps[0], gs.snps[1], gs.indels[0], gs.indels[1],
            gs.multi[0], gs.multi[1], gs.dbSNP_sites[0], gs.dbSNP_sites[1],
            gs.dbSNP_var[0], gs.dbSNP_var[1], gs.CpG_ref[0], gs.CpG_ref[1],
            gs.CpG_nonref[0], gs.CpG_nonref[1],
        ]
    return m


def _matrix_to_ctg_stats(universe, m):
    from bs_call_tpu.stats.collect import CtgStats

    out = []
    for i, (name, _ln) in enumerate(universe):
        r = [int(x) for x in m[i]]
        cs = CtgStats(
            snps=r[0:2], indels=r[2:4], multi=r[4:6],
            dbSNP_sites=r[6:8], dbSNP_var=r[8:10],
            CpG_ref=r[10:12], CpG_nonref=r[12:14],
        )
        out.append((name, cs))
    return out


def contig_universe(cfg):
    """(name, length) list = reference faidx ∩ SAM header — identical on
    every host, so the LPT assignment is deterministic (the reference's
    process_sam_header.c:52-70 contract)."""
    from bs_call_tpu.io.fasta import FastaIndex
    from bs_call_tpu.io.sam import open_alignment_file

    reader = open_alignment_file(cfg.input_file, native=False)
    fasta = FastaIndex(cfg.reference_file)
    header_names = set(reader.header.ref_names)
    universe = [
        (e.name, e.length) for e in fasta.entries if e.name in header_names
    ]
    if hasattr(reader, "close"):
        reader.close()
    return universe


def run_multihost(
    cfg,
    num_hosts: int,
    host_id: int,
    coordinator: str = None,
):
    """One host's share of a multi-host run (the reference's external
    per-contig sharding + bcftools concat, made first-class: SURVEY §2.4).

    Calls this host's LPT contig assignment with a uniform header (so the
    per-host VCFs concatenate), then — when a coordinator brought up
    jax.distributed — merges the JSON stats across hosts with one psum
    and returns the GLOBAL stats on every host (report written by the
    caller on host 0). Without a coordinator, returns this host's local
    stats.

    Returns (stats|None, ordered_ctg_stats|None, wrote_output: bool)."""
    import os
    import tempfile

    from bs_call_tpu.utils import configure_jax

    jax = configure_jax()
    # explicit platform pin for deployments that must keep every host's
    # process on one platform
    plat = os.environ.get("BS_CALL_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
    if coordinator:
        # on the CPU backend cross-process collectives need gloo
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
        initialize(coordinator, num_hosts, host_id)
    universe = contig_universe(cfg)
    mine = my_contigs(universe, num_hosts, host_id)
    collect = bool(cfg.report_file)
    stats = None
    table = None
    wrote = False
    tmp_bed = None
    tmp_sizes = None
    try:
        if mine:
            fd, tmp_bed = tempfile.mkstemp(suffix=".bed")
            with os.fdopen(fd, "w") as bed:
                sizes = dict(universe)
                for name in mine:
                    bed.write(f"{name}\t0\t{sizes[name]}\n")
            cfg.contig_bed = tmp_bed
            if not cfg.contig_sizes:
                # uniform header universe (the -s contract)
                fd, tmp_sizes = tempfile.mkstemp(suffix=".sizes")
                with os.fdopen(fd, "w") as f:
                    for name, ln in universe:
                        f.write(f"{name}\t{ln}\n")
                cfg.contig_sizes = tmp_sizes
            if collect:
                stats = BsStats()
            from bs_call_tpu.pipeline.runner import run_caller

            stats, table = run_caller(cfg, stats=stats)
            wrote = True
        elif collect:
            stats = BsStats()  # empty contribution to the collective
        if collect and coordinator:
            ctg_local = (
                _ctg_stats_matrix(universe, table)
                if table is not None
                else np.zeros((len(universe), 14), dtype=np.int64)
            )
            merged_ctg = psum_arrays({"ctg": ctg_local})["ctg"]
            stats = merge_stats_collective(stats)
            # zero-count contigs are gated out by the report writer
            ordered = _matrix_to_ctg_stats(universe, merged_ctg)
            return stats, ordered, wrote
        if collect and table is not None:
            ordered = [
                (c.name, c.ctg_stats)
                for c in table.contigs
                if c.ctg_stats is not None
            ]
            return stats, ordered, wrote
        return stats, [], wrote
    finally:
        for p in (tmp_bed, tmp_sizes):
            if p:
                try:
                    os.unlink(p)
                except OSError:
                    pass
