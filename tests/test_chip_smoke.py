"""chip_smoke.py and the bench sections it runs: each section at a tiny
size on the CPU (the card runs them at full size), the script's refusal to
run without a GPU, and where the compile cache goes."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402

TINY_SECTIONS = {
    "eager_f64": lambda: bench.eager_f64(d=4),
    "cn_step": lambda: bench.cn_step(rmax=4, d=6, steps=2),
    "batched_als_vmap": lambda: bench.batched_als(d=6, rmax=8, batch=3),
    "batched_als_explicit": lambda: bench.batched_als(
        d=6, rmax=8, batch=3, impl="explicit"),
    "dmrg": lambda: bench.dmrg(d=6, rmax=8, sweeps=3),
    "tdvp1": lambda: bench.tdvp1(d=6, rmax=4, steps=2),
    "tdvp2": lambda: bench.tdvp2(d=6, rmax=4, steps=2),
    "cross_maxvol": lambda: bench.cross("maxvol", batch=2, rank=4,
                                        n_iters=2),
    "cross_dmrg": lambda: bench.cross("dmrg", batch=2, rank=4, n_iters=2),
    "mc_batched_als": lambda: bench.multichip_batched_als(
        4, d=6, rmax=8, batch=8),
    "mc_cn_tp": lambda: bench.multichip_cn_tp(4, d=6, rmax=4),
    "mc_tsqr": lambda: bench.multichip_tsqr(4, rows_per_device=32, cols=8),
}


@pytest.mark.parametrize("name", sorted(TINY_SECTIONS))
def test_section_passes_its_gate_at_tiny_size(name):
    rec = TINY_SECTIONS[name]()
    assert set(rec) >= {"phase", "compile_s", "run_s", "gate", "limit",
                        "precision", "peak_bytes"}
    assert rec["compile_s"] > 0 and rec["run_s"] > 0
    for key, value in rec["gate"].items():
        assert value <= rec["limit"][key]
    json.dumps(rec)


def test_failed_gate_raises():
    with pytest.raises(RuntimeError, match="gate residual"):
        bench._record("x", 1.0, 1.0, {"residual": 1.0}, {"residual": 0.1},
                      "highest")
    with pytest.raises(RuntimeError):
        bench._record("x", 1.0, 1.0, {"residual": float("nan")},
                      {"residual": 0.1}, "highest")


def test_multichip_stage_must_touch_every_device():
    on_one = jax.device_put(jax.numpy.zeros((8, 2)), jax.devices()[0])
    with pytest.raises(RuntimeError, match="1 of 4 devices"):
        bench._spread(on_one, 4)


def test_phase_lists():
    assert len(chip_smoke.multichip_phases(bench, 4)) == 3
    phases = chip_smoke.single_card_phases(bench)
    assert len(phases) >= 10 and all(callable(p) for p in phases)


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = bench.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_follows_variable(monkeypatch, tmp_path,
                                        restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bench.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_sync_and_time_waits_for_the_result():
    from ttnx.utils.profiling import sync_and_time

    f = jax.jit(lambda x: (x @ x).sum())
    x = jax.numpy.ones((64, 64))
    seconds, out = sync_and_time(f, x, iters=3)
    assert seconds > 0 and float(out) == 64.0 ** 3


@pytest.mark.gpu
def test_cn_step_on_card(gpu):
    rec = bench.cn_step(rmax=16, d=8, steps=2)
    assert rec["gate"]["residual"] <= rec["limit"]["residual"]
