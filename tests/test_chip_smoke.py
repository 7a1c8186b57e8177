"""``chip_smoke.py``: it refuses to run off a GPU or outside the repository,
its checks fail loudly, its MBPO arguments are the flagship runscript's
widths, and its comparison phases run (on the CPU, at tiny sizes)."""

import os
import shlex
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_device_check_fails_on_cpu():
    proc = _run(REPO, "chip_smoke.py")
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path, "chip_smoke.py")
    assert proc.returncode != 0
    assert "repository root" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_check_prints_errors_and_fails_above_tolerance(capsys):
    chip_smoke.check("phase", {"a": (1e-6, 1e-5)})
    assert "phase: a=1.000e-06 (tol 1e-05)" in capsys.readouterr().out
    with pytest.raises(chip_smoke.Failed, match="b above tolerance"):
        chip_smoke.check("phase", {"a": (1e-6, 1e-5), "b": (2.0, 1.0)})
    with pytest.raises(chip_smoke.Failed):
        chip_smoke.check("phase", {"nan": (float("nan"), 1.0)})


def _runscript_flags(name):
    """``{flag: value}`` of the runscript's ``mbrl.script`` command."""
    with open(os.path.join(REPO, "runscripts", name)) as f:
        text = f.read().replace("\\\n", " ")
    cmd = text.split("pdecontrol_tpu.mbrl.script", 1)[1].split('"$@"')[0]
    words = shlex.split(cmd)
    return {w[2:]: v for w, v in zip(words, words[1:]) if w.startswith("--")}


def test_mbpo_widths_match_flagship_runscript():
    """Every width flag the smoke shares with runscripts/mbpo_ks.sh has the
    runscript's value; only length and fit caps differ."""
    import json

    script = _runscript_flags("mbpo_ks.sh")
    argv = chip_smoke.MBPO_FLAGSHIP
    smoke = dict(zip(argv[::2], argv[1::2]))
    shared = {k for k in script if f"--{k}" in smoke}
    assert {"factory", "training", "curriculum", "loss",
            "rollout_length_schedule",
            "policy_train_steps_per_sample"} <= shared
    for k in shared:
        a, b = script[k], smoke[f"--{k}"]
        if a.startswith("{"):
            a, b = json.loads(a), json.loads(b)
        assert a == b, k


@pytest.mark.parametrize("dp", [1, 2])
def test_mbpo_window_has_25_iterations_at_any_data_width(dp):
    """The one-card window and the 2x2 mesh window both run 25 iterations
    with a fit every 10th and an evaluation every 10th."""
    from pdecontrol_tpu.mbrl import script

    argv = (chip_smoke.MBPO_FLAGSHIP + chip_smoke.mbpo_length(dp)
            + ["--num_envs", str(10 * dp), "--data_parallel", str(dp)])
    cfg = script.config_from_args(script.build_parser().parse_args(argv))
    per_iteration = cfg.num_envs * cfg.rollout_length
    assert (cfg.total_timesteps - cfg.learning_starts) // per_iteration == 25
    assert cfg.surrogate_train_freq // per_iteration == 10
    assert cfg.agent_eval_freq == 10


def test_comparison_phases_run_on_cpu(capsys):
    cpu = jax.devices("cpu")[0]
    chip_smoke.solver_phase(cpu, cpu, batch=32, golden_rows=4,
                            golden_periods=1)
    chip_smoke.surrogate_phase(cpu, cpu, batch=2)
    out = capsys.readouterr().out
    assert "ks_u=0.000e+00" in out and "golden_u=" in out
    assert "surrogate (conv-LSTM B=2 T=15" in out
