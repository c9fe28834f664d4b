"""Byte parity of the native row engine (bsc_rowengine.cpp) against
the regular engine + vector-emitter path.

The row engine chains pileup -> aggregate -> f64 model -> Fisher ->
emit prep -> stats -> formatting natively (one load/model/emit triple
per block); the Python path it replaces stays the behavioral
reference. These tests run the CLI in subprocesses with the row engine
on vs off (BS_CALL_ROW_ENGINE=0) and assert identical VCF bytes and
identical JSON reports on a fixture exercising pairs, overlaps, dups,
indels, soft clips and both bisulfite strands.

Subprocesses (not in-process): the test session pins an 8-device
virtual CPU mesh, where engine._prefer_xla_f64 deliberately routes
through the XLA mesh kernel instead of the row engine.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bs_call_tpu.io.bam import (
    BamHeader,
    BamWriter,
    FDUP,
    FMREVERSE,
    FPAIRED,
    FPROPER_PAIR,
    FREAD1,
    FREAD2,
    FREVERSE,
    aux_tag,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # no virtual mesh in the children
    env["PYTHONPATH"] = REPO
    return env


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rowe")
    rng = np.random.default_rng(7)
    ctg_len = 6000
    names = ["chrA", "chrB"]
    seqs = []
    ref = tmp / "ref.fa"
    with open(ref, "w") as f:
        for name in names:
            seq = "".join(rng.choice(list("ACGT"), ctg_len))
            # salt CpGs so the methylation/CpG stats paths run
            seq = list(seq)
            for p in range(100, ctg_len - 2, 97):
                seq[p], seq[p + 1] = "C", "G"
            seq = "".join(seq)
            seqs.append(seq)
            f.write(f">{name}\n")
            for i in range(0, ctg_len, 60):
                f.write(seq[i : i + 60] + "\n")
    hdr = BamHeader(
        text="@HD\tVN:1.6\tSO:coordinate\n"
        + "".join(f"@SQ\tSN:{n}\tLN:{ctg_len}\n" for n in names),
        ref_names=names,
        ref_lens=[ctg_len] * 2,
    )
    bam = tmp / "in.bam"
    w = BamWriter(str(bam), hdr)
    rl = 80
    for tid in (0, 1):
        seq = seqs[tid]
        recs = []
        n = 0
        while n < 600:
            pos1 = int(rng.integers(0, ctg_len - 3 * rl))
            conv = "C" if rng.random() < 0.5 else "G"
            tag = aux_tag("XB", "A", conv)
            mapq = int(rng.integers(10, 60))

            def rd(pos, ln=rl):
                s = list(seq[pos : pos + ln])
                for k in range(len(s)):
                    if conv == "C" and s[k] == "C" and rng.random() < 0.7:
                        s[k] = "T"
                    if conv == "G" and s[k] == "G" and rng.random() < 0.6:
                        s[k] = "A"
                    if rng.random() < 0.01:
                        s[k] = "ACGT"[int(rng.integers(4))]
                return "".join(s)

            kind = rng.random()
            if kind < 0.6:
                gap = int(rng.integers(-rl + 10, 60))
                pos2 = pos1 + rl + gap
                isize = pos2 + rl - pos1
                f1 = FPAIRED | FPROPER_PAIR | FMREVERSE | FREAD1
                f2 = FPAIRED | FPROPER_PAIR | FREVERSE | FREAD2
                if rng.random() < 0.05:
                    f1 |= FDUP
                    f2 |= FDUP
                recs.append((pos1, f"t{tid}p{n}", f1, tid, pos1, mapq,
                             [(rl, 0)], tid, pos2, isize, rd(pos1),
                             rng.integers(15, 44, rl).astype(np.uint8),
                             tag))
                recs.append((pos2, f"t{tid}p{n}", f2, tid, pos2, mapq,
                             [(rl, 0)], tid, pos1, -isize, rd(pos2),
                             rng.integers(15, 44, rl).astype(np.uint8),
                             tag))
                n += 2
            else:
                r = rng.random()
                if r < 0.25:
                    cigar = [(5, 4), (rl - 5, 0)]
                    s = "ACACA" + rd(pos1, rl - 5)
                elif r < 0.5:
                    half = rl // 2
                    cigar = [(half, 0), (2, 2), (rl - half, 0)]
                    s = rd(pos1, half) + rd(pos1 + half + 2, rl - half)
                elif r < 0.65:
                    half = rl // 2
                    cigar = [(half, 0), (2, 1), (rl - half - 2, 0)]
                    s = rd(pos1, half) + "TT" + rd(pos1 + half,
                                                   rl - half - 2)
                else:
                    cigar = [(rl, 0)]
                    s = rd(pos1)
                flag = FREVERSE if rng.random() < 0.5 else 0
                recs.append((pos1, f"t{tid}s{n}", flag, tid, pos1, mapq,
                             cigar, -1, -1, 0, s,
                             rng.integers(15, 44, len(s)).astype(
                                 np.uint8), tag))
                n += 1
        recs.sort(key=lambda r: r[0])
        for rec in recs:
            w.write(*rec[1:])
    w.close()
    return str(bam), str(ref), str(tmp)


def _run(bam, ref, out, extra, env):
    r = subprocess.run(
        [sys.executable, "-m", "bs_call_tpu.cli", bam, "-r", ref,
         "-o", out, "--benchmark-mode", "-n", "S", *extra],
        capture_output=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-800:].decode("utf-8", "replace")
    return r.stderr.decode("utf-8", "replace")


@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["-A"],
        ["--report-file", "{tmp}/rep.json"],
        ["-A", "--report-file", "{tmp}/rep.json", "-L", "3", "-R", "2"],
        ["-q", "0", "-Q", "13"],
    ],
    ids=["default", "all-pos", "report", "trims+report", "thresholds"],
)
def test_row_engine_byte_parity(fixture, extra):
    bam, ref, tmp = fixture
    env_on = _host_env()
    env_off = _host_env()
    env_off["BS_CALL_ROW_ENGINE"] = "0"
    extra_on = [e.replace("{tmp}", tmp) for e in extra]
    extra_off = [
        e.replace("{tmp}/rep.json", f"{tmp}/rep_off.json") for e in extra
    ]
    err = _run(bam, ref, f"{tmp}/on.vcf", extra_on + ["-v"], env_on)
    assert "using native row engine" in err
    _run(bam, ref, f"{tmp}/off.vcf", extra_off, env_off)
    with open(f"{tmp}/on.vcf", "rb") as a, open(f"{tmp}/off.vcf",
                                                "rb") as b:
        assert a.read() == b.read()
    if "--report-file" in extra:
        ra = json.load(open(f"{tmp}/rep.json"))
        rb = json.load(open(f"{tmp}/rep_off.json"))
        ra.pop("date", None)
        rb.pop("date", None)
        assert ra == rb


def test_row_engine_vcf_gz_parity(fixture):
    """bgzf-compressed text output goes through the same byte stream."""
    bam, ref, tmp = fixture
    env_on = _host_env()
    env_off = _host_env()
    env_off["BS_CALL_ROW_ENGINE"] = "0"
    err = _run(bam, ref, f"{tmp}/on.vcf.gz", ["-O", "z", "-v"], env_on)
    assert "using native row engine" in err
    _run(bam, ref, f"{tmp}/off.vcf.gz", ["-O", "z"], env_off)
    with open(f"{tmp}/on.vcf.gz", "rb") as a, open(f"{tmp}/off.vcf.gz",
                                                   "rb") as b:
        assert a.read() == b.read()


def test_row_engine_dbsnp_falls_back(fixture):
    """-D runs must keep working (regular path; rs annotation intact)."""
    bam, ref, tmp = fixture
    from bs_call_tpu.io.dbsnp_idx import DbSnpIndexBuilder

    b = DbSnpIndexBuilder(header="track name=t")
    for pos in (101, 150, 250):
        b.add_snp("chrA", pos, f"rs{pos}")
    b.write(f"{tmp}/idx.bin")
    env = _host_env()
    err = _run(bam, ref, f"{tmp}/db.vcf", ["-D", f"{tmp}/idx.bin", "-v",
                                           "-A"], env)
    assert "using native row engine" not in err
    with open(f"{tmp}/db.vcf") as f:
        assert "rs101" in f.read()
