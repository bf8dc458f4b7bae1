"""CPU checks of the GPU entry points' own logic: the compile-cache
helper, the device check that keeps chip_smoke.py and bench.py off the
CPU, and chip_smoke's phase-5 KKT-apply comparison at a small width."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from swarm_simulator_tpu.utils import runtime  # noqa: E402

CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def cache_config():
    """Restore the process-wide cache settings the helper changes."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert (ROOT / "swarm_simulator_tpu").is_dir()
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_compile_cache_honours_env(tmp_path, cache_config):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets no directory
    in code, and compiled programs land in that directory."""
    before = jax.config.jax_compilation_cache_dir
    code = (
        "import jax, jax.numpy as jnp\n"
        "from swarm_simulator_tpu.utils import runtime\n"
        "print(runtime.enable_compile_cache())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
        " 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()"
        "\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == str(tmp_path)
    assert any(tmp_path.iterdir()), "no cache entry written"
    # in-process: the env var wins and the config is left alone
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    try:
        assert runtime.enable_compile_cache() == str(tmp_path)
    finally:
        del os.environ["JAX_COMPILATION_CACHE_DIR"]
    assert jax.config.jax_compilation_cache_dir == before


def test_device_check_refuses_cpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_check()
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_kkt_apply_comparison_small_width():
    """Phase 5's comparison on the CPU at bs = 27: the 'device' apply is
    the CPU float32 apply itself, so it meets its own bound exactly."""
    from test_nullspace import _data

    from swarm_simulator_tpu.qp import nullspace

    data, _ = _data(n_agents=3, M=5)
    data = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if np.asarray(a).dtype == np.float64 else np.asarray(a), data)
    op = jax.device_put(nullspace.prepare_ns_np(
        data, nullspace.NSSettings(kkt_mode="banded", n_rungs=3)))
    errs = chip_smoke.kkt_apply_errors(op, 3, 5, 3,
                                       device=jax.devices("cpu")[0])
    assert len(errs) == 3
    for e in errs:
        assert e["ok"], e
        assert e["err_highest"] == e["err_cpu32"]
        assert 0.0 < e["err_cpu32"] < 1e-4, e
        assert e["bound"] == max(chip_smoke.ERR_FACTOR * e["err_cpu32"],
                                 chip_smoke.ERR_FLOOR)
    assert chip_smoke.kkt_apply_ms(op, 3, 5, 3, reps=2) > 0.0
