"""Test configuration: run everything on a virtual 8-device CPU mesh.

Standard JAX fake-backend trick (SURVEY.md §4): sharding tests assert
sharded == single-device without real devices. Must run before jax import.

Tests marked ``gpu`` need the card: they skip on the CPU (decided per test
by the ``_skip_gpu_tests_off_card`` fixture, never at import) and run from
``chip_smoke.py``, which holds the card and sets ``CUSMC_TESTS_ON_CARD=1``
so that this file leaves the platform alone.
"""

import os

ON_CARD = os.environ.get("CUSMC_TESTS_ON_CARD") == "1"

if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")

# Double precision for closed-form oracles (library code stays dtype-explicit
# float32 on its hot paths; this only affects test-side references).
jax.config.update("jax_enable_x64", True)

# Tests compile many small shapes; keep them out of the persistent compile
# cache that the entry points (CLI, bench, chip_smoke) enable.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


def pytest_configure(config):
    """Register the markers, and build the native host lib if missing so
    the native-IO tests run (native/build is gitignored; without this the
    4 native tests skip silently on fresh checkouts)."""
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; run by chip_smoke.py")
    config.addinivalue_line("markers", "slow: long-running test")
    import pathlib
    import subprocess

    native = pathlib.Path(__file__).resolve().parent.parent / "native"
    lib = native / "build" / "libcusmc_host.so"
    if native.is_dir() and not lib.exists():
        try:
            subprocess.run(["make", "-C", str(native)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"warning: native lib build failed ({e}); "
                  "native-IO tests will skip")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_card(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py)")


@pytest.fixture
def key():
    return jax.random.key(0)
