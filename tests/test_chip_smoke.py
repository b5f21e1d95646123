"""chip_smoke.py off the card: its device check, and its phases rehearsed
on the CPU at QVGA.  The rehearsals prove the phases' control flow and
checks; only the run on the GPU proves that the card runs them."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(args, env_extra, timeout):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_device_check_refuses_cpu():
    r = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"}, timeout=300)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["bench.py", "--skip-extras"], {"JAX_PLATFORMS": "cpu"},
             timeout=300)
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr
    assert "metric" not in r.stdout


def test_check_raises_phase_failure():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.PhaseFailed, match="broken"):
        chip_smoke.check(False, "broken")


def test_report_prints_one_json_line(capsys):
    chip_smoke.report("phase", a=1, b=[2.5, "x"])
    line = capsys.readouterr().out.strip()
    name, body = line.split(": ", 1)
    fields = json.loads(body)
    assert name == "phase" and fields.pop("at_s") >= 0
    assert fields == {"a": 1, "b": [2.5, "x"]}


def test_full_size_is_the_reference_width():
    s = chip_smoke.FULL
    assert (s.width, s.n_features, s.n_levels) == (640, 1024, 8)
    assert s.mono_warm + s.mono_stream == 112
    # 1.2 of LongBench's 3.1 laps over 1248 frames
    assert abs(s.loop_frames / 1248 * 3.1 - 1.2) < 0.01


def test_ba_grid_problem_shapes():
    g = chip_smoke._ba_grid_problem(n_cams=6, n_feat=64, n_pts=128)
    assert g.R.shape == (6, 3, 3) and g.points.shape == (128, 3)
    assert g.pt_loc.shape == g.uv.shape[:2] == (6, 64)
    assert int(np.asarray(g.pt_loc).max()) < 128
    assert np.asarray(g.cam_fixed).sum() == 4


@pytest.mark.slow
def test_one_card_phases_rehearse_on_cpu():
    chip_smoke.run_one_card(chip_smoke.QVGA)


@pytest.mark.slow
def test_four_card_phase_rehearses_on_four_cpu_devices():
    r = _run(["-c", "import chip_smoke as c; c.phase_four(c.QVGA)"],
             {"JAX_PLATFORMS": "cpu",
              "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
             timeout=3000)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "four.dist_ba" in r.stdout


@pytest.mark.gpu
def test_stages_match_cpu_on_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this phase")
    img = np.random.RandomState(0).randint(0, 255, (480, 640), np.uint8)
    chip_smoke.phase_stages(chip_smoke.FULL, img)
