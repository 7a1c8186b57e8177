"""Process set-up shared by the entry points (``utils/runtime.py``): the
compile-cache rule, the device report, and the optional plots."""

import os

import jax
import pytest

from pdecontrol_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_follows_env_var(monkeypatch, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    the code sets no other (JAX reads the variable itself)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert runtime.cache_dir() == "/some/cache"
    assert runtime.enable_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = os.path.join(REPO, ".jax_cache")
    assert runtime.cache_dir() == expected
    assert runtime.enable_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert ".jax_cache/" in ignored
    assert "native/build/" in ignored


def test_report_device_on_cpu(capsys):
    info = runtime.report_device("unit")
    assert info["platform"] == "cpu" and info["count"] >= 1
    assert ("[unit] device: platform=cpu kind=cpu count="
            in capsys.readouterr().out)


def test_gpu_name_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert runtime.gpu_name_and_power_limit() == "not available"


def test_cli_prints_device(tmp_path, capsys, restore_cache_config):
    from pdecontrol_tpu.evaluation import generate

    out = tmp_path / "d.npz"
    generate.main(["--output", str(out), "--episodes", "2", "--config",
                   '{"n": 16, "cfg_steps": 2, "t_max": 0.5}'])
    assert "[generate] device: platform=cpu" in capsys.readouterr().out
    assert out.exists()


def test_plots_off_without_matplotlib(monkeypatch, tmp_path, capsys):
    """Missing plotting packages: one notice at start-up, plot jobs never
    submitted (npz artifacts still are)."""
    from pdecontrol_tpu import viz
    from pdecontrol_tpu.mbrl.config import MBPOConfig
    from pdecontrol_tpu.mbrl.controller import PDEModelBasedController

    assert viz.available()  # installed here
    monkeypatch.setattr(viz, "available", lambda: False)
    ctl = PDEModelBasedController(MBPOConfig(
        run_dir=str(tmp_path), env_config={"n": 16, "cfg_steps": 2,
                                           "t_max": 0.5},
        num_envs=2, pool_size=4, capacity=64, num_dynamics_models=1,
        num_elite_models=1, logging_freq=1, precompile_horizons=False,
    ))
    out = capsys.readouterr().out
    assert out.count("plots are off") == 1
    submitted = []
    monkeypatch.setattr(ctl.viz, "submit", submitted.append)
    ctl._save_plots(None, None, None, None)
    assert not submitted
