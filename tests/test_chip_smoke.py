"""chip_smoke.py and the entry-point helpers it shares, on the CPU: the
device check refuses a CPU device, the last line has the exact contract
format, and the compile cache lands where the environment says."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import pytest

from cusmc_tpu.utils import compile_cache
from cusmc_tpu.utils.device import require_gpu

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu([])


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is False
    assert last["device"]["platform"] == "cpu"


@pytest.mark.parametrize("count", [1, 4])
def test_final_line_format(count):
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = _chip_smoke().final_line(True, [dev] * count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": %d}}' % count)
    assert set(json.loads(line)) == {"ok", "device"}


def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert os.path.realpath(path) == os.path.realpath(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert compile_cache.enable_compile_cache() == path   # same every call


@pytest.mark.parametrize("phase", ["phase_sharded_metropolis",
                                   "phase_sharded_ring"])
def test_four_card_exchange_checks_on_cpu(monkeypatch, phase):
    # The exact exchange checks of --chips 4, on four CPU devices at a
    # small width: they pass on the working exchanges.
    mod = _chip_smoke()
    monkeypatch.setattr(mod, "N_FULL", 1024)
    detail = getattr(mod, phase)()
    assert f"all {4 * 1024} slots" in detail
    if phase == "phase_sharded_ring":
        assert "span-bounded, 1 while_loop round(s)" in detail


@pytest.mark.parametrize("shift,ok", [(0.0, True), (1.0, False)])
def test_within_limits_difference_in_standard_errors(shift, ok):
    mod = _chip_smoke()
    a = [1.0, 1.1, 0.9, 1.05]
    b = [x + shift for x in a]
    if ok:
        assert "+0.00 se" in mod._within(a, b, "x")
    else:
        with pytest.raises(AssertionError, match="x: 4 cards"):
            mod._within(a, b, "x")
