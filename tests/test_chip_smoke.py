"""chip_smoke.py and the run-environment helpers it shares with bench.py:
the platform refusal, the compile-cache rule, the nvidia-smi line, and the
four-card phase on virtual CPU devices.  The one-card phases run at toy
sizes in tests/test_chip_smoke_phases.py; on a GPU machine the gpu-marked
test runs the script itself."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from loik_tpu.utils import runenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_ok_line(text):
    return not any(ln.startswith('{"ok"') for ln in text.splitlines())


def test_main_exits_nonzero_on_cpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert _no_ok_line(out.out)
    assert "needs a GPU" in out.err


def test_bench_main_exits_nonzero_on_cpu(monkeypatch, capsys):
    import bench

    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit) as ei:
        bench.main()
    assert ei.value.code not in (0, None)
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo the
    script exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert _no_ok_line(proc.stdout)


@pytest.mark.parametrize("env,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(REPO, ".jax_cache")),
])
def test_compile_cache_dir(env, expected):
    """The variable, when set, wins (the program sets no directory);
    otherwise the cache lives in the checkout."""
    assert runenv.compile_cache_dir(env) == expected


def test_parse_card_line():
    rec = runenv.parse_card_line("NVIDIA H100 80GB HBM3, 700.00 W\n")
    assert rec == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    with pytest.raises(ValueError):
        runenv.parse_card_line("no comma here")


def test_device_record_names_the_device():
    rec = runenv.device_record(["NVIDIA H100 80GB HBM3, 500.00 W"])
    assert rec["platform"] == jax.devices()[0].platform
    assert rec["device_kind"] == jax.devices()[0].device_kind
    assert rec["device_count"] == len(jax.devices())
    assert rec["card_power_limit"] == "500.00 W"
    assert "card_name" not in runenv.device_record([])


def test_cards_phase_on_virtual_devices():
    """The --cards 4 path (solve_sharded + multistart over a 4-device mesh
    against single-device runs) on four virtual CPU devices."""
    devices = jax.devices()[:4]
    assert len(devices) == 4
    rec = chip_smoke.phase_cards(devices, B_per=8, n_seeds_per=8)
    assert rec["pass"], rec
    assert rec["sharded"]["devices"] == 4
    assert rec["sharded"]["flag_diffs"] == 0
    assert rec["multistart"]["seeds"] == 32


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke run on the card, in a child process that owns it."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1].startswith('{"ok": true')
