"""utils/synth.py: generating contigs in worker processes writes the same
bytes as generating them in process."""

import hashlib

from bs_call_tpu.utils import synth


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_parallel_generation_is_byte_identical(tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    ra, ba, na = synth.make_wgbs_fixture(str(a), 2000, 20_000, seed=3,
                                         n_contigs=3)
    monkeypatch.setattr(synth, "POOL_MIN_READS", 0)
    monkeypatch.setattr(synth.os, "cpu_count", lambda: 2)
    rb, bb, nb = synth.make_wgbs_fixture(str(b), 2000, 20_000, seed=3,
                                         n_contigs=3)
    assert na == nb > 0
    assert _digest(ra) == _digest(rb)
    assert _digest(ba) == _digest(bb)
