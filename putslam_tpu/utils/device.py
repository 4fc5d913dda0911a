"""Which accelerator a run used, and where its compiled programs are cached.

Nothing here imports JAX at module import, so a test's ``conftest.py`` can
call :func:`enable_compile_cache` before it picks the platform.
"""

from __future__ import annotations

import os
import subprocess

_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """JAX's persistent compilation cache: ``$JAX_COMPILATION_CACHE_DIR``
    when the environment sets it, else the fixed in-checkout ``.cache/jax``
    (a fixed path, so a later run of the same checkout finds it again)."""
    return os.environ.get(_CACHE_ENV) or os.path.join(_CHECKOUT, ".cache",
                                                      "jax")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself and
    nothing is set here; otherwise the cache goes to ``.cache/jax``."""
    path = compile_cache_dir()
    if not os.environ.get(_CACHE_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The JAX devices, or ``SystemExit`` (non-zero) when the first one is
    not a GPU: a run that is meant for the card must not fall back to the
    CPU and report the CPU's numbers."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this run needs the card")
    return devs


def card_name_and_power() -> str:
    """Each card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them. Read by a
    child process, which stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
