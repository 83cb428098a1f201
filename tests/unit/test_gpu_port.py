"""What keeps the program a GPU program: no TPU-only Pallas module is
imported and nothing branches on the TPU, the compile cache lands where
it should, and chip_smoke.py refuses to report without a GPU."""

import ast
import os
import shutil
import subprocess
import sys

import jax
import pytest

from ofdm_uhd_tpu.core import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _py_files(sub):
    base = os.path.join(ROOT, sub)
    if sub == ".":
        return [os.path.join(ROOT, f) for f in os.listdir(ROOT)
                if f.endswith(".py")]
    return [os.path.join(d, f) for d, _, fs in os.walk(base)
            for f in fs if f.endswith(".py")]


def _tpu_uses(path):
    """Imports of a TPU-only Pallas module, and comparisons against the
    string 'tpu' (a branch on the TPU backend)."""
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = {a.name for a in node.names}
            if (mod.endswith("pallas.tpu") or mod.endswith("mosaic")
                    or ("pallas" in mod and "tpu" in names)):
                found.append(f"{path}:{node.lineno} from {mod} import")
        elif isinstance(node, ast.Import):
            found += [f"{path}:{node.lineno} import {a.name}"
                      for a in node.names if "pallas.tpu" in a.name]
        elif isinstance(node, ast.Compare):
            consts = [c for c in [node.left, *node.comparators]
                      if isinstance(c, ast.Constant)]
            if any(c.value == "tpu" for c in consts):
                found.append(f"{path}:{node.lineno} compares with 'tpu'")
    return found


@pytest.mark.parametrize("sub", ["ofdm_uhd_tpu", "bench", "tests", "."])
def test_no_tpu_only_module_or_branch(sub):
    # this file names the patterns it looks for, so it is left out
    files = [f for f in _py_files(sub) if f != os.path.abspath(__file__)]
    assert files
    found = [u for f in files for u in _tpu_uses(f)]
    assert not found, found


def test_scan_finds_a_tpu_import(tmp_path):
    """The scan itself catches what it is for."""
    p = tmp_path / "k.py"
    p.write_text("from jax.experimental.pallas import tpu as pltpu\n"
                 "interpret = jax.default_backend() != 'tpu'\n")
    assert len(_tpu_uses(str(p))) == 2


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, restore_cache_dir,
                                    tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # set nothing


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    assert d == os.path.join(ROOT, "bench_cache", "jax")
    assert jax.config.jax_compilation_cache_dir == d
    assert compile_cache.enable_compile_cache() == d         # stable
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "bench_cache/" in f.read().split(), \
            "the cache directory must be gitignored"


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stderr, r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert "ofdm_uhd_tpu" in r.stderr, r.stderr
    assert '"ok"' not in r.stdout
