"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases runs at tiny size on CPU devices (the four-card one on four
virtual devices)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out):
    for line in out.splitlines():
        try:
            assert "ok" not in json.loads(line)
        except (json.JSONDecodeError, TypeError):
            pass


def test_exits_nonzero_without_gpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    _no_result(r.stdout)


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    _no_result(r.stdout)


def test_phase_kernels_tiny():
    times = chip_smoke.phase_kernels(batch=2, num_points=300,
                                     npoints=(64, 32), k=8, n_queries=32,
                                     interpret=True)
    assert set(times) == {"fps_triton_64_ms", "fps_xla_64_ms",
                          "fps_triton_32_ms", "fps_xla_32_ms", "knn_k8_ms"}


def test_check_knn_accepts_ties_only():
    pts = np.array([[[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 3, 0]]],
                   np.float32)
    # 1 and 2 tie exactly: either order passes
    assert chip_smoke.check_knn(np.array([[[0, 2, 1]] * 4]), pts,
                                [(0, 0)], 3) == 1
    with pytest.raises(AssertionError, match="mismatch"):
        chip_smoke.check_knn(np.array([[[0, 1, 3]] * 4]), pts, [(0, 0)], 3)
    with pytest.raises(AssertionError, match="slot 0"):
        chip_smoke.check_knn(np.array([[[1, 0, 2]] * 4]), pts, [(0, 0)], 3)


def test_compare_bounds_share_of_points():
    a = np.zeros((1, 1000, 4))
    b = a.copy()
    b[0, :2] = 1.0  # 0.2% of the points flipped
    chip_smoke.compare("within share", b, a, 1e-4)
    b[0, :3] = 1.0
    with pytest.raises(AssertionError, match="outside tolerance"):
        chip_smoke.compare("beyond share", b, a, 1e-4)


def test_phase_forward_tiny():
    times = chip_smoke.phase_forward(batch=2, num_points=256, n_cmp=1)
    assert set(times) == {"demo_stage2_fwd_ms", "demo_stage3_fwd_ms"}


def test_phase_train_tiny():
    (det_ms, det_gdiff), (glo_ms, glo_gdiff) = chip_smoke.phase_train(
        pairs=2, tuples=1, num_points=64, kp=8)
    assert det_ms > 0 and glo_ms > 0
    assert det_gdiff == 0.0 and glo_gdiff == 0.0  # CPU sums are ordered


def test_four_card_checks_on_virtual_devices():
    chip_smoke.four_card_checks(jax.devices()[:4], pairs_per_card=1,
                                num_points=64, kp=8)
