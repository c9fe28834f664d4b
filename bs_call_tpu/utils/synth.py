"""Synthetic WGBS fixture generator shared by bench.py, chip_smoke.py, the
multichip dry run (__graft_entry__) and the multi-host tests.

One realistic generator instead of three toy ones:
~70% proper pairs (some overlapping), bisulfite conversion with per-read
strand tags, SNPs, indels, soft clips, flagged + positional duplicates,
and mixed mapping/base qualities — the read-shape state space the
production pipeline actually handles (reference behaviors:
get_template_vector.c pairing/dups, al_utils.c overlap/clip handling,
input_sam.c strand tags).
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np


# per-contig reads from which make_wgbs_fixture generates contigs in
# spawned workers (below it, worker start-up costs more than it saves)
POOL_MIN_READS = 100_000


def make_wgbs_fixture(tmp, n_reads, ctg_len, seed=0, n_contigs=1):
    """Write ref.fa + in.bam under `tmp`. With n_contigs > 1, n_reads
    are generated PER CONTIG (chr1..chrN, each ctg_len bp) so
    per-contig shard workers get equal work; at POOL_MIN_READS and more
    the contigs are generated in spawned workers, one per contig up to
    the core count. Returns (ref_path, bam_path, total_records)."""
    from bs_call_tpu.io.bam import BamHeader, BamWriter

    names = [f"chr{c + 1}" for c in range(n_contigs)]
    ref = os.path.join(tmp, "ref.fa")
    seqs = []
    with open(ref, "w") as f:
        for c in range(n_contigs):
            rng = np.random.default_rng(seed + 7919 * c)
            seq_arr = rng.choice(list("ACGT"), ctg_len)
            for p in range(200, ctg_len - 2, 211):  # salt CpGs
                seq_arr[p] = "C"
                seq_arr[p + 1] = "G"
            seqs.append("".join(seq_arr))
            f.write(f">{names[c]}\n")
            for i in range(0, ctg_len, 60):
                f.write(seqs[c][i : i + 60] + "\n")
    bam = os.path.join(tmp, "in.bam")
    hdr = BamHeader(
        text="@HD\tVN:1.6\tSO:coordinate\n"
        + "".join(f"@SQ\tSN:{n}\tLN:{ctg_len}\n" for n in names),
        ref_names=names,
        ref_lens=[ctg_len] * n_contigs,
    )
    w = BamWriter(bam, hdr)
    jobs = [
        (c, seqs[c], n_reads, ctg_len, seed + 7919 * c)
        for c in range(n_contigs)
    ]
    workers = min(n_contigs, os.cpu_count() or 1)
    total = 0
    with contextlib.ExitStack() as stack:
        mapper = map
        if workers > 1 and n_reads >= POOL_MIN_READS:
            mapper = stack.enter_context(ProcessPoolExecutor(
                workers, mp_context=mp.get_context("spawn")
            )).map
        for n, blob in mapper(_contig_records, jobs):
            w.write_encoded(blob)
            total += n
    w.close()
    return ref, bam, total


def _contig_records(job):
    """(n_records, serialized records) for one contig."""
    from bs_call_tpu.io.bam import encode_record

    recs = contig_reads(*job)
    return len(recs), b"".join(encode_record(*r) for r in recs)


def contig_reads(tid, seq, n_reads, ctg_len, seed):
    """~n_reads coordinate-sorted records for one contig, each the
    argument tuple of BamWriter.write."""
    from bs_call_tpu.io.bam import (
        FDUP,
        FMREVERSE,
        FPAIRED,
        FPROPER_PAIR,
        FREAD1,
        FREAD2,
        FREVERSE,
        aux_tag,
    )

    rng = np.random.default_rng(seed)
    rl = 150
    snp_pos = rng.integers(0, ctg_len, ctg_len // 1000)
    # sample-genome view: reference with heterozygous-style SNPs applied
    # once, so read generation is a vectorized slice + conversion mask
    base = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
    base[snp_pos] = np.frombuffer(b"ACGT", dtype=np.uint8)[
        (base[snp_pos] + 1) % 4
    ]
    C, G, T, A = (ord(c) for c in "CGTA")

    def read_seq(pos, conv, length=rl):
        s = base[pos : pos + length].copy()
        if conv == "C":
            s[(s == C) & (rng.random(len(s)) < 0.7)] = T
        else:
            s[(s == G) & (rng.random(len(s)) < 0.6)] = A
        return s.tobytes().decode()

    recs = []
    n = 0
    while n < n_reads:
        pos1 = int(rng.integers(0, ctg_len - 3 * rl))
        conv = "C" if rng.random() < 0.5 else "G"
        tag = aux_tag("XB", "A", conv)
        mapq = int(rng.integers(10, 60))
        kind = rng.random()
        if kind < 0.7 and n + 2 <= n_reads:
            gap = int(rng.integers(-rl + 20, 80))
            pos2 = pos1 + rl + gap
            isize = pos2 + rl - pos1
            f1 = FPAIRED | FPROPER_PAIR | FMREVERSE | FREAD1
            f2 = FPAIRED | FPROPER_PAIR | FREVERSE | FREAD2
            dup = rng.random() < 0.03
            if dup:
                f1 |= FDUP
                f2 |= FDUP
            q1 = rng.integers(15, 44, rl).astype(np.uint8)
            q2 = rng.integers(15, 44, rl).astype(np.uint8)
            recs.append(
                (pos1, f"c{tid}p{n}", f1, tid, pos1, mapq, [(rl, 0)],
                 tid, pos2, isize, read_seq(pos1, conv), q1, tag)
            )
            recs.append(
                (pos2, f"c{tid}p{n}", f2, tid, pos2, mapq, [(rl, 0)],
                 tid, pos1, -isize, read_seq(pos2, conv), q2, tag)
            )
            n += 2
        else:
            r = rng.random()
            if r < 0.2:
                cigar = [(6, 4), (rl - 6, 0)]
                s = "ACACAC" + read_seq(pos1, conv, rl - 6)
            elif r < 0.4:
                half = rl // 2
                cigar = [(half, 0), (3, 2), (rl - half, 0)]
                s = read_seq(pos1, conv, half) + read_seq(
                    pos1 + half + 3, conv, rl - half
                )
            elif r < 0.5:
                half = rl // 2
                cigar = [(half, 0), (2, 1), (rl - half - 2, 0)]
                s = (
                    read_seq(pos1, conv, half)
                    + "TT"
                    + read_seq(pos1 + half, conv, rl - half - 2)
                )
            else:
                cigar = [(rl, 0)]
                s = read_seq(pos1, conv)
            flag = FREVERSE if rng.random() < 0.5 else 0
            q = rng.integers(15, 44, len(s)).astype(np.uint8)
            recs.append(
                (pos1, f"c{tid}s{n}", flag, tid, pos1, mapq, cigar, -1,
                 -1, 0, s, q, tag)
            )
            n += 1
            if rng.random() < 0.05 and n < n_reads:  # positional dup
                recs.append(
                    (pos1, f"c{tid}s{n}", flag, tid, pos1, mapq, cigar,
                     -1, -1, 0, s,
                     rng.integers(15, 44, len(s)).astype(np.uint8), tag)
                )
                n += 1
    recs.sort(key=lambda r: r[0])
    return [r[1:] for r in recs]


def make_dbsnp_index(path, contigs, ctg_len, seed=0, every=503):
    """Small dbSNP binary index covering positions `every` apart on each
    contig (1-based), for -D runs over the synthetic fixture. Returns
    `path`."""
    from bs_call_tpu.io.dbsnp_idx import DbSnpIndexBuilder

    b = DbSnpIndexBuilder(header="track name=synth")
    for name in contigs:
        for pos in range(17, ctg_len, every):
            b.add_snp(name, pos, f"rs{pos}")
    b.write(path)
    return path
