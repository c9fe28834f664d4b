"""The device choice: --device gpu fails loudly without a GPU and never
degrades to the host; device errors propagate; --device auto without a
GPU stays on the host engines in process; shard workers refuse the GPU;
the compilation cache location; chip_smoke.py without a GPU."""

import io
import os
import shutil
import subprocess
import sys

import jax
import pytest

from bs_call_tpu.cli import main
from bs_call_tpu.config import CallerConfig
from bs_call_tpu.native import load
from bs_call_tpu.pipeline.engine import CallEngine
from bs_call_tpu.pipeline.runner import run_caller
from bs_call_tpu.utils import NoGpuError

from test_native_pipeline import random_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = jax.devices("cpu")[0]


def _env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p
    )
    env.update(kw)
    return env


def test_device_gpu_without_gpu_exits_nonzero(tmp_path, capsys):
    ref, bam = random_bam(tmp_path, n_pairs=50, seed=1)
    out = tmp_path / "out.vcf"
    rc = main([str(bam), "-r", str(ref), "-o", str(out), "--device", "gpu"])
    assert rc != 0
    assert "--device gpu" in capsys.readouterr().err
    assert not out.exists()
    with pytest.raises(NoGpuError):
        CallEngine(CallerConfig(device="gpu"))


def test_device_error_propagates(tmp_path, monkeypatch):
    """A failing device call surfaces; nothing finishes on the host."""
    from bs_call_tpu.ops.kernels import pileup_device

    if load() is None:
        pytest.skip("native toolchain unavailable")
    ref, bam = random_bam(tmp_path, n_pairs=200, seed=2)

    def boom(*a, **k):
        raise RuntimeError("device failure")

    monkeypatch.setattr(pileup_device, "fused_ll_f64", boom)
    cfg = CallerConfig(
        input_file=str(bam), reference_file=str(ref), device="gpu",
        use_mesh=False, batch_positions=1 << 12,
    )
    with pytest.raises(RuntimeError, match="device failure"):
        run_caller(cfg, out_fileobj=io.BytesIO(), device=CPU)


def test_auto_without_gpu_stays_on_host_in_process(tmp_path, monkeypatch):
    """device=auto with no GPU: no subprocess, no read export, the host
    engines' bytes."""
    if load() is None:
        pytest.skip("native toolchain unavailable")
    ref, bam = random_bam(tmp_path, n_pairs=300, seed=3)

    def vcf(device):
        cfg = CallerConfig(
            input_file=str(bam), reference_file=str(ref),
            benchmark_mode=True, device=device,
        )
        buf = io.BytesIO()
        run_caller(cfg, out_fileobj=buf)
        return buf.getvalue()

    want = vcf("cpu")

    def no_spawn(*a, **k):
        raise AssertionError("device=auto spawned a subprocess")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    assert vcf("auto") == want
    eng = CallEngine(CallerConfig(device="auto"))
    assert eng._tier_device() is None and not eng.wants_reads()


def test_shards_refuse_device_gpu(tmp_path, capsys):
    from bs_call_tpu.parallel.shard_runner import run_sharded

    ref, bam = random_bam(tmp_path, n_pairs=50, seed=4)
    out = tmp_path / "out.vcf"
    rc = main([str(bam), "-r", str(ref), "-o", str(out), "--device", "gpu",
               "--shards", "2"])
    assert rc != 0
    assert "--shards" in capsys.readouterr().err
    assert not out.exists()
    cfg = CallerConfig(input_file=str(bam), reference_file=str(ref),
                       device="gpu")
    with pytest.raises(ValueError):
        run_sharded(cfg, 2, str(out))


@pytest.mark.parametrize("preset", [False, True])
def test_compilation_cache_dir(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR, when set, is left alone; otherwise the
    cache lives at a fixed path in the checkout."""
    from bs_call_tpu.utils import JAX_CACHE_DIR

    env = _env(JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "mine")
    r = subprocess.run(
        [sys.executable, "-c",
         "from bs_call_tpu.utils import configure_jax;"
         "print(configure_jax().config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    want = str(tmp_path / "mine") if preset else JAX_CACHE_DIR
    assert r.stdout.strip() == want
    assert JAX_CACHE_DIR.startswith(REPO + os.sep)


def test_chip_smoke_without_gpu_fails():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=300, cwd=REPO,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")], env=env,
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert os.listdir(tmp_path) == ["chip_smoke.py"]
