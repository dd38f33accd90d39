"""``serve --aot-cache DIR``: the port's compiled libraries built into and
loaded from a cache directory (utils/aot.py).  Here with the g++ library of
monotonic alignment search (``ops.mas.maximum_path(native=True)``); the
nvcc libraries of the kernels take the same path on the card (chip_smoke.py
[19]).  A fresh 0700 directory builds (a miss); a second interpreter loads
it (a hit) without running g++, which it would have to call through
``subprocess.run``; an edited source misses; a world-writable directory is
refused; and the server's CLI takes the flag."""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from cosy_tpu_torch import native
from cosy_tpu_torch.ops.mas import maximum_path
from cosy_tpu_torch.utils import aot
from test_torch_common import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture
def cache(tmp_path):
    d = tmp_path / "aot"
    assert aot.set_cache_dir(str(d)) == d
    yield d
    aot.set_cache_dir(None)


def _mas_once():
    value = np.random.default_rng(0).standard_normal((2, 6, 14)).astype(np.float32)
    return maximum_path(value, np.array([6, 4]), np.array([14, 9]))


def test_fresh_directory_builds_there_and_a_second_process_loads_it(cache):
    assert stat.S_IMODE(os.stat(cache).st_mode) == 0o700
    before = dict(aot.AOT_STATS)
    path = _mas_once()
    libs = sorted(p.name for p in cache.iterdir() if p.suffix == ".so")
    assert len(libs) == 1 and libs[0].startswith("libmas_")
    assert aot.AOT_STATS["misses"] == before["misses"] + 1
    assert aot.AOT_STATS["hits"] == before["hits"]
    code = (
        "import subprocess, sys, numpy as np\n"
        "from cosy_tpu_torch.utils import aot\n"
        "from cosy_tpu_torch.ops.mas import maximum_path\n"
        "def no_compiler(*a, **k):\n"
        "    raise AssertionError(f'a compiler ran: {a}')\n"
        "subprocess.run = no_compiler\n"
        "aot.set_cache_dir(sys.argv[1])\n"
        "v = np.random.default_rng(0).standard_normal((2, 6, 14)).astype(np.float32)\n"
        "p = maximum_path(v, np.array([6, 4]), np.array([14, 9]))\n"
        "np.save(sys.argv[2], p)\n"
        "print(aot.AOT_STATS)\n")
    out = str(cache.parent / "child.npy")
    res = subprocess.run([sys.executable, "-c", code, str(cache), out], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "{'hits': 1, 'misses': 0}" in res.stdout
    np.testing.assert_array_equal(np.load(out), path)


def test_an_edited_source_misses(cache, tmp_path, monkeypatch):
    _mas_once()
    src = tmp_path / "src"
    src.mkdir()
    (src / "mas.cpp").write_text((native.SRC_DIR / "mas.cpp").read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    before = dict(aot.AOT_STATS)
    path = _mas_once()
    assert aot.AOT_STATS["misses"] == before["misses"] + 1
    assert len([p for p in cache.iterdir() if p.suffix == ".so"]) == 2
    assert path.sum() > 0


def test_a_world_writable_directory_is_refused(tmp_path):
    d = tmp_path / "open"
    d.mkdir()
    os.chmod(d, 0o777)
    with pytest.raises(aot.UntrustedCacheDir, match="world-writable"):
        aot.set_cache_dir(str(d))
    assert aot.cache_dir() == aot.DEFAULT_DIR
    # a directory opened up after it was set is refused at the next load
    good = tmp_path / "good"
    aot.set_cache_dir(str(good))
    try:
        os.chmod(good, 0o770)
        with pytest.raises(aot.UntrustedCacheDir):
            aot.library_dir()
    finally:
        aot.set_cache_dir(None)


def test_serve_cli_takes_the_flag(tmp_path):
    d = tmp_path / "cache"
    res = subprocess.run([sys.executable, "-m", "cosy_tpu_torch.serve", "--aot-cache", str(d),
                          "--device", "cpu", "--model-dir", str(tmp_path / "no_model")],
                         cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=120)
    # past flag checking: the cache is set, then the missing model dir stops it
    assert f"library cache: {d}" in res.stdout, res.stdout + res.stderr
    assert "not ported" not in res.stdout + res.stderr and "missing" in res.stderr
    assert stat.S_IMODE(os.stat(d).st_mode) == 0o700
