"""Test configuration: the CPU platform with 8 virtual devices.

The tests run on the CPU. Multi-device sharding paths are checked on XLA's
host-platform virtual devices; the GPU path is checked by
``python chip_smoke.py`` on the card. Tests that need the card carry the
``gpu`` marker and skip, from inside the test, when there is none.
"""

import os
import subprocess

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from putslam_tpu.utils.device import enable_compile_cache  # noqa: E402

# Persistent compilation cache: the per-module jax.clear_caches() below
# (XLA:CPU segfault workaround) forces recompiles of shared programs in
# every module — the disk cache turns those into deserializations. The
# XLA:CPU AOT loader logs spurious machine-feature-mismatch errors on
# load (the printed feature sets are identical modulo +/- notation —
# upstream cosmetic bug); harmless, captured by pytest.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

assert jax.devices()[0].platform == "cpu"
assert len(jax.devices()) == 8


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_card():
    """The card's name and power limit; skips the test where there is no
    card. Asks nvidia-smi, because this process is held to the CPU."""
    from putslam_tpu.utils.device import card_name_and_power

    try:
        return card_name_and_power()
    except (OSError, subprocess.SubprocessError):
        pytest.skip("needs an NVIDIA GPU (nvidia-smi found no card)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Reset JAX's compiled-executable caches between test modules.

    The full suite accumulates hundreds of XLA:CPU executables in one
    process; past ~110 tests the next compilation segfaults inside
    backend_compile_and_load (deterministically, only in the full-suite
    order — every subset passes). Clearing per module keeps peak JIT state
    bounded and sidesteps the crash at the cost of some recompilation.

    Round-4 repro hunt (tools/xla_cpu_segfault_repro.py): 400 distinct
    scan-containing compilations on the 8-virtual-device CPU client do NOT
    reproduce — executable-count accumulation alone is not the trigger; the
    crash needs the suite's real program mix (donation / shard_map /
    multi-process among them). Left as a documented workaround; the script
    is the starting point for an upstream-reportable repro."""
    yield
    jax.clear_caches()
