"""Persistent-compilation-cache recipe (docs/API.md section
"Compile latency & the persistent compilation cache").

The reference pays its specialisation cost at C++ compile time
(templates, README.md:20); the JAX analogue is trace-time
specialisation whose compiled executables can persist across
processes.  These tests pin the recipe: a decode populates the cache,
and a second process reuses the entries instead of re-compiling.

Subprocess-based: the cache config must be set before the first
dispatch, and each subprocess is a fresh backend.
"""

import os
import subprocess
import sys

from viterbidecodercpp_jax.utils import compile_cache

_CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_DRIVER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from viterbidecodercpp_jax.utils import compile_cache
print("CACHE", compile_cache.enable())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
import numpy as np
import viterbidecodercpp_jax as vt

code = vt.get_code("Voyager")
config = vt.get_decode_config(vt.DecodeType.SOFT16, code.R)
dec = vt.ViterbiDecoder(code, config, backend="xla", traceback_length=32)
rng = np.random.RandomState(0)
T = 32 + code.K - 1
syms = rng.randint(config.soft_decision_low, config.soft_decision_high + 1,
                   (2, T * code.R)).astype(np.int32)
bits, err, acc = dec.decode(syms, 32)
print("BITSUM", int(np.asarray(bits).sum()))
"""


def _run(cache_dir):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    r = subprocess.run(
        [sys.executable, "-c", _DRIVER],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=_CHECKOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"CACHE {cache_dir}" in r.stdout, r.stdout
    line = [l for l in r.stdout.splitlines() if l.startswith("BITSUM")]
    assert line, r.stdout
    return int(line[0].split()[1])


def test_cache_populates_and_is_reused(tmp_path):
    cache = str(tmp_path / "jitcache")
    os.makedirs(cache)

    first = _run(cache)
    entries = sorted(os.listdir(cache))
    assert entries, "first run wrote no cache entries"
    mtimes = {e: os.path.getmtime(os.path.join(cache, e)) for e in entries}

    second = _run(cache)
    assert second == first
    entries2 = sorted(os.listdir(cache))
    # no new compiles...
    assert entries2 == entries
    # ...and no overwrites: every entry was served from disk untouched
    for e in entries:
        assert os.path.getmtime(os.path.join(cache, e)) == mtimes[e], (
            f"cache entry {e} was rewritten (compile happened twice)")


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(_CHECKOUT, ".jax_cache")
