"""Process-level device setup: the persistent compile cache and the card's
identity as ``nvidia-smi`` reports it."""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["enable_compile_cache", "card_info"]

#: root of the checkout this package was imported from
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX (which reads it
    at start-up) and no other directory is configured; otherwise the cache
    lives at ``<checkout>/.jax_cache``, a fixed path, so later runs of the
    same checkout hit it.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_info() -> str:
    """``name, power.limit`` of each GPU, one line per card, as
    ``nvidia-smi`` reports them (raises when nvidia-smi is unavailable)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
