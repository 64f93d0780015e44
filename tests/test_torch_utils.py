"""The port's ``utils.rng`` and ``utils.cache``.

``RngStream`` holds the JAX class's contract (``tests/test_utils.py:18-26``)
with torch generators in place of keys: one seed gives one sequence, seeds
differ, ``fold`` derives without advancing, ``count`` counts what ``next``
and ``next_n`` handed out, and the children are independent streams.  Its
bits are its own, never the JAX keys'.  ``enable_persistent_cache`` chooses
the kernels' build directory (``directory``, then ``IST_COMPILE_CACHE``,
then ``build/kernels``), the kernel library builds into it (checked with
the compiler and the loader replaced, so no ``nvcc`` is needed), and moving
it after a load raises.
"""

import ctypes
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu_torch import _kernels
from imagined_speech_translation_tpu_torch.utils import RngStream, seed_everything
from imagined_speech_translation_tpu_torch.utils import cache

REPO = Path(__file__).resolve().parents[1]


def _draw(g, n=4):
    return torch.rand(n, generator=g)


def test_rng_stream_deterministic():
    a, b = RngStream(42), RngStream(42)
    for _ in range(3):
        assert torch.equal(_draw(a.next()), _draw(b.next()))
    assert a.count == 3
    assert torch.equal(_draw(a.next_n(2)[1]), _draw(b.next_n(2)[1]))
    assert a.count == b.count == 5


def test_rng_stream_seeds_differ():
    assert not torch.equal(_draw(RngStream(1).next()), _draw(RngStream(2).next()))


def test_rng_stream_fold_does_not_advance():
    s, fresh = RngStream(7), RngStream(7)
    f5 = _draw(s.fold(5))
    assert torch.equal(_draw(s.fold(5)), f5)
    assert not torch.equal(_draw(s.fold(6)), f5)
    assert s.count == 0
    first = _draw(s.next())
    assert torch.equal(first, _draw(fresh.next()))  # the folds took nothing
    assert not torch.equal(first, f5)
    assert not torch.equal(_draw(s.fold(5)), f5)  # the stream's state moved


def test_rng_stream_children_are_independent():
    s = RngStream(0)
    draws = [_draw(g, 1000) for g in s.next_n(3)] + [_draw(s.next(), 1000)]
    assert s.count == 4
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
            assert abs(np.corrcoef(draws[i], draws[j])[0, 1]) < 0.1
    g = RngStream(0, device="cpu").next()
    assert g.device == torch.device("cpu")


def test_seed_everything_reproducible():
    assert seed_everything(42) == 42
    a = (np.random.rand(3), torch.rand(3))
    seed_everything(42)
    b = (np.random.rand(3), torch.rand(3))
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1])


@pytest.fixture
def fresh_cache(monkeypatch):
    """No directory chosen and no library loaded; both restored after."""
    monkeypatch.setattr(cache, "_chosen", None)
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "_lib_dir", None)
    monkeypatch.delenv("IST_COMPILE_CACHE", raising=False)


def test_cache_directory_order(fresh_cache, monkeypatch, tmp_path):
    assert cache.kernel_build_dir() == REPO / "build" / "kernels"
    assert cache.enable_persistent_cache() == str(REPO / "build" / "kernels")
    monkeypatch.setenv("IST_COMPILE_CACHE", str(tmp_path / "env"))
    assert cache.enable_persistent_cache() == str(tmp_path / "env")
    assert cache.kernel_build_dir() == tmp_path / "env"
    assert cache.enable_persistent_cache(tmp_path / "arg") == str(tmp_path / "arg")
    assert cache.kernel_build_dir() == tmp_path / "arg"


def test_kernels_build_where_the_cache_points(fresh_cache, monkeypatch, tmp_path):
    built = []

    def fake_build(so, tag):
        built.append(so)
        so.write_bytes(b"")
        return "ptxas info"

    class FakeLib:
        def __getattr__(self, name):
            fn = SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_kernels, "_build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    chosen = Path(cache.enable_persistent_cache(tmp_path / "kernels"))
    _kernels.library()
    assert len(built) == 1 and built[0].parent == chosen
    assert built[0].name.startswith("libist_kernels-")
    assert (chosen / built[0].with_suffix(".log").name).read_text() == "ptxas info"
    assert _kernels.loaded_build_dir() == chosen
    # the same directory again is fine; another one, after the load, raises
    assert cache.enable_persistent_cache(tmp_path / "kernels") == str(chosen)
    with pytest.raises(RuntimeError, match="already loaded"):
        cache.enable_persistent_cache(tmp_path / "elsewhere")
    monkeypatch.setenv("IST_COMPILE_CACHE", str(tmp_path / "env"))
    with pytest.raises(RuntimeError, match="already loaded"):
        cache.enable_persistent_cache()
    assert cache.kernel_build_dir() == chosen
