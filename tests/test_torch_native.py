"""The port's C++ packer and unit-string codec (`slamkit_tpu_torch/native/`)
against their Python paths and the JAX package's: the same rows and columns
from greedy and best-fit-decreasing packing (tie cases included: equal
lengths, equal remaining room), the same row counts, the same strings and
units, exactly. And the build: a library per source hash under
`build/native/`, never beside its source, and a failed build remembered.
"""
import numpy as np
import pytest

import slamkit_tpu.native.pack as jax_pack
import slamkit_tpu.tokeniser.unit_codec as jax_codec
from slamkit_tpu_torch.data import pack
from slamkit_tpu_torch.native import _build
from slamkit_tpu_torch.native import codec as native_codec
from slamkit_tpu_torch.native import pack as native_pack
from slamkit_tpu_torch.tokeniser import unit_codec


def _cases():
    rng = np.random.default_rng(1)
    yield "random", rng.integers(0, 50, 500), (50, 64, 128)
    yield "ties", rng.integers(1, 8, 300), (8, 9, 16)      # many equal lengths and rooms
    yield "equal", np.full(40, 3), (6, 7, 9)
    yield "fits_exactly", np.array([4, 4, 2, 2, 6, 2, 8, 1, 7, 0, 8]), (8,)
    yield "empty", np.zeros(0, np.int64), (8,)


@pytest.mark.parametrize("name,lens,widths", list(_cases()), ids=[c[0] for c in _cases()])
def test_packers_equal_python_and_jax(name, lens, widths, monkeypatch):
    assert pack._get_native() is native_pack
    for t in widths:
        native = (pack.bestfit_pack(lens, t), pack.greedy_pack(lens, t, 3, 5),
                  pack.greedy_pack(lens, t), pack.greedy_pack_count(lens, t))
        with monkeypatch.context() as m:
            m.setattr(pack, "_native", False)
            python = (pack.bestfit_pack(lens, t), pack.greedy_pack(lens, t, 3, 5),
                      pack.greedy_pack(lens, t), pack.greedy_pack_count(lens, t))
        jax = (jax_pack.bestfit_pack(lens, t), jax_pack.greedy_pack(lens, t, 3, 5),
               jax_pack.greedy_pack(lens, t), jax_pack.greedy_pack_count(lens, t))
        for got in (native, python):
            for a, b in zip(got[:3], jax[:3]):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y, err_msg=f"{name} T={t}")
            assert got[3] == jax[3]


def test_codec_equals_python_and_jax(monkeypatch):
    rng = np.random.default_rng(2)
    units = [rng.integers(0, 500, n) for n in (0, 1, 7, 300)] + [np.array([0, 9, 10, 99, 100])]
    texts = ["<Un3>x<Un49><Un>< Un5><Un7", "", "noise<Un12><Un0012>>", "<Un<Un8>"]
    assert unit_codec._get_native() is native_codec
    native = ([unit_codec.units_to_string(u) for u in units],
              [unit_codec.units_to_string(u.tolist()) for u in units],
              [unit_codec.string_to_units(t) for t in texts])
    monkeypatch.setattr(unit_codec, "_native", False)
    python = ([unit_codec.units_to_string(u) for u in units],
              [unit_codec.units_to_string(u.tolist()) for u in units],
              [unit_codec.string_to_units(t) for t in texts])
    jax = ([jax_codec.units_to_string(u) for u in units],
           [jax_codec.units_to_string(u.tolist()) for u in units],
           [jax_codec.string_to_units(t) for t in texts])
    for got in (native, python):
        assert got[0] == got[1] == jax[0]
        for a, b in zip(got[2], jax[2]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
    assert native[2][0].tolist() == [3, 49] and native[2][2].tolist() == [12, 12]
    for u, s in zip(units, native[0]):
        np.testing.assert_array_equal(unit_codec.string_to_units(s), u)


def test_libraries_build_by_hash_outside_the_package():
    for name in ("pack", "codec"):
        _build.load(name)
        lib = _build.library_path(name)
        assert lib.is_file() and lib.parent.parent == _build.BUILD_ROOT
        assert lib.parent.name.startswith(f"{name}-") and len(lib.parent.name) == len(name) + 17
    assert not list(_build.HERE.glob("*.so"))


def test_a_failed_build_is_remembered(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "HERE", tmp_path)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "LIBS", {"broken": ()})
    monkeypatch.setattr(_build, "_loaded", {})
    calls = []
    real_build = _build.build
    monkeypatch.setattr(_build, "build", lambda name: calls.append(name) or real_build(name))
    for _ in range(3):
        with pytest.raises(_build.NativeUnavailable, match="g\\+\\+ failed"):
            _build.load("broken")
    assert calls == ["broken"]
    built = list((tmp_path / "build").rglob("*"))
    assert [p for p in built if p.is_file()] == []     # no truncated library left behind
