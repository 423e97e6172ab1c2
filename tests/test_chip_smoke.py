"""chip_smoke.py and bench.py on the CPU: they refuse to run without a GPU,
and chip_smoke's phases rehearse at a tiny size (the GPU run is
`python chip_smoke.py`). Also the installation contract the card relies
on: no PyYAML on the main path, and the compile cache's location."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=REPO)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    assert '"ok"' not in p.stdout and "frames_per_second" not in p.stdout
    # it stopped before building or compiling anything
    assert "parity" not in p.stdout


def test_main_path_imports_without_pyyaml():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import ssvio_tpu.system\n"
            "from ssvio_tpu.config import Settings\n"
            "try:\n"
            "    Settings.from_yaml('unused.yaml')\n"
            "except ImportError as e:\n"
            "    assert 'PyYAML' in str(e), e\n"
            "    print('clear ImportError')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "clear ImportError" in p.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from ssvio_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)
    cache.enable_compile_cache(min_compile_secs=2.0)
    # the environment owns the directory: nothing here set another
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from ssvio_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compile_cache_dir() == os.path.join(REPO, ".cache", "jax")
    assert cache.compile_cache_dir() == cache.compile_cache_dir()


def _tiny_settings():
    import bench

    s = bench.make_settings()
    fx = 360.0
    s.cam_left = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=128.0,
                                     cy=64.0)
    s.cam_right = dataclasses.replace(s.cam_right, fx=fx, fy=fx, cx=128.0,
                                      cy=64.0)
    s.image_width, s.image_height = 256, 128
    s.baseline_fx = 0.54 * fx
    s.max_features = 128
    s.max_landmarks = 1024
    s.max_window = 8
    s.active_map_size = 6
    s.min_init_landmarks = 40
    s.init_good = 40
    s.tracking_good = 40
    s.grid_cell = 24
    s.loop_db_min_size = 8
    return s


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("phase", ["parity", "straight", "loop", "four"])
def test_phase_rehearsal(chip_smoke, phase):
    """Each phase's control flow at 256x128, 2 chunks, on CPU devices: the
    kernel in the interpreter, the four-device path on virtual devices.
    The accuracy gates that need the full-size scene are the GPU run's."""
    s = _tiny_settings()
    if phase == "parity":
        chip_smoke.phase_parity(s, "cpu", kernel_impl="interpret")
    elif phase == "straight":
        r = chip_smoke.phase_straight(s, "cpu", n_frames=2 * chip_smoke.CHUNK,
                                      max_ate=1.0)
        assert np.isfinite(r["fps"]) and len(r["chunk_s"]) == 2
    elif phase == "loop":
        r = chip_smoke.phase_loop(s, "cpu", laps=1, lap_frames=64,
                                  require_closure=False)
        assert np.isfinite(r["ate_on"]) and np.isfinite(r["ate_off"])
    else:
        chip_smoke.phase_four_gpus(s, "cpu", jax.devices())
