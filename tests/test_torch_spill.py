"""The port's token spill and dataset cache against the JAX package's
(`slamkit_tpu/data/dataset.py`):

  * `TokenWriter`, `load_token_dataset` and `interleave` (both stopping
    strategies, a repeated corpus, the mixed buffer gathered in small slabs)
    with a `spill_tokens` below the corpus: the same tokens, starts and
    lengths bit for bit, the buffer an np.memmap whose file is already
    unlinked, and batches equal to those of the in-RAM build;
  * the `saved_ds_path` format: a cache written by either package (and the
    round-1 `token_dataset.npz`) loads in the other to the same rows;
  * `init_dataset` with `data.saved_ds_path`, one corpus and a mixed list:
    the first call writes the cache, the second loads it without reading
    the jsonl, and both give the JAX package's rows and batches.
"""
import json
import os

import numpy as np
import pytest

import slamkit_tpu.data.dataset as jax_dataset
import slamkit_tpu_torch.data.dataset as dataset
from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu_torch.tokeniser import UnitTokeniser


class Node(dict):   # the JAX package reads a config's attributes as well as its keys
    __getattr__ = dict.__getitem__


def _write_corpus(path, n, seed, hi=90):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            units = rng.integers(0, 500, int(rng.integers(1, hi)))
            f.write(json.dumps({"file_name": f"r{i}",
                                "audio_repr": "".join(f"<Un{u}>" for u in units)}) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("spill")
    return [_write_corpus(d / f"c{i}.jsonl", n, seed=i) for i, n in enumerate((60, 35, 20))]


def _assert_same(got, want):
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert len(got) == len(want)
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))


def _rows(ds):
    return [ds[i].tolist() for i in range(len(ds))]


def _batches(mod, ds, packing=True):
    b = mod.Batcher(ds, 4, 32, pad_id=0, packing=packing, shuffle=True, seed=1,
                    packing_strategy="bestfit")
    return [{k: np.asarray(v) for k, v in x.items()} for x in b.epoch(0)]


def _assert_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("spill_tokens", [0, 150, 1 << 30])
def test_token_writer_spills_like_jax(tmp_path, spill_tokens):
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 500, int(n)).tolist() for n in rng.integers(0, 40, 30)]
    made = []
    for mod in (dataset, jax_dataset):
        w = mod.TokenWriter(spill_tokens=spill_tokens, spill_dir=str(tmp_path / mod.__name__))
        for s in seqs:
            w.append(s)
        made.append(w.finish())
    got, want = made
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert isinstance(got.tokens, np.memmap) == (spill_tokens < sum(map(len, seqs)))
    assert isinstance(want.tokens, np.memmap) == isinstance(got.tokens, np.memmap)
    spill_dir = tmp_path / dataset.__name__                  # the spill file is unlinked
    assert not spill_dir.exists() or not os.listdir(spill_dir)


def test_load_and_interleave_spill_like_jax(corpora, tmp_path, monkeypatch):
    tok, jtok = UnitTokeniser(), JaxUnitTokeniser(load_fe=False)
    spill = dict(spill_tokens=100, spill_dir=str(tmp_path / "spill"))
    got = [dataset.load_token_dataset(c, tok, **spill) for c in corpora]
    want = [jax_dataset.load_token_dataset(c, jtok, **spill) for c in corpora]
    in_ram = [dataset.load_token_dataset(c, tok) for c in corpora]
    for g, w, r in zip(got, want, in_ram):
        assert isinstance(g.tokens, np.memmap) and not isinstance(r.tokens, np.memmap)
        _assert_same(g, w)
        _assert_same(r, w)
    got[1], want[1], in_ram[1] = got[1].repeat(2), want[1].repeat(2), in_ram[1].repeat(2)
    for strategy in ("first_exhausted", "all_exhausted"):
        mixed = dataset.interleave(got, [0.5, 0.3, 0.2], strategy, seed=0, **spill)
        jmixed = jax_dataset.interleave(want, [0.5, 0.3, 0.2], strategy, seed=0, **spill)
        ram = dataset.interleave(in_ram, [0.5, 0.3, 0.2], strategy, seed=0)
        assert isinstance(mixed.tokens, np.memmap) and not isinstance(ram.tokens, np.memmap)
        _assert_same(mixed, jmixed)
        _assert_same(ram, jmixed)
        _assert_batches(_batches(dataset, mixed), _batches(dataset, ram))
        _assert_batches(_batches(dataset, mixed), _batches(jax_dataset, jmixed))
        _assert_batches(_batches(dataset, mixed, packing=False), _batches(jax_dataset, jmixed,
                                                                         packing=False))
    assert os.listdir(tmp_path / "spill") == []             # every spill file unlinked
    # the mixed buffer gathered in slabs of ~50 tokens
    rng = np.random.default_rng(3)
    src = rng.integers(0, 3, 80)
    idx = np.array([rng.integers(0, len(got[s])) for s in src])
    _assert_same(dataset._materialize_picks(got, src, idx, slab_tokens=50, **spill),
                 jax_dataset._materialize_picks(want, src, idx, slab_tokens=50, **spill))


def test_caches_load_across_packages(corpora, tmp_path):
    tok = UnitTokeniser()
    ds = dataset.load_token_dataset(corpora[0], tok, spill_tokens=10,
                                    spill_dir=str(tmp_path)).chunk(16).filter_by_length(min_len=3)
    want = _rows(ds)
    ds.save(str(tmp_path / "port"))
    jloaded = jax_dataset.TokenDataset.load(str(tmp_path / "port"))
    assert _rows(jloaded) == want
    jloaded.save(str(tmp_path / "jax"))
    for name in ("tokens.bin", "offsets.npy"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    loaded = dataset.TokenDataset.load(str(tmp_path / "jax"))
    assert isinstance(loaded.tokens, np.memmap) and _rows(loaded) == want
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    np.savez(legacy / "token_dataset.npz", tokens=np.concatenate([ds[i] for i in range(len(ds))]),
             offsets=ds.offsets)
    assert _rows(dataset.TokenDataset.load(str(legacy))) == want
    assert _rows(jax_dataset.TokenDataset.load(str(legacy))) == want
    empty = dataset.TokenDataset.from_lists([])
    empty.save(str(tmp_path / "empty"))
    assert len(dataset.TokenDataset.load(str(tmp_path / "empty"))) == 0


@pytest.mark.parametrize("mixed", [False, True], ids=["one_corpus", "mixed_list"])
def test_init_dataset_saved_ds_path_equals_jax(corpora, tmp_path, monkeypatch, mixed):
    data = {"sample_units_max_length": 80, "chunk_units_min_length": 3, "spill_tokens": 200,
            "spill_dir": str(tmp_path / "spill"), "saved_ds_path": str(tmp_path / "cache")}
    if mixed:
        data.update(train_path=corpora, train_ratios=[0.6, 0.4, 0.2], repetitions=[1, 2, 1],
                    val_path=corpora[:2])
    else:
        data.update(train_path=corpora[0], val_path=corpora[2])
    cfg = Node(data=Node(data), model=Node(context_len=32))
    jcfg = Node(data=Node({**data, "saved_ds_path": None}), model=Node(context_len=32))
    want = jax_dataset.init_dataset(jcfg, JaxUnitTokeniser(load_fe=False))
    first = dataset.init_dataset(cfg, UnitTokeniser())
    assert sorted(os.listdir(tmp_path / "cache")) == ["train", "validation"]
    assert isinstance(first["train"].tokens, np.memmap)

    def no_jsonl(*args, **kwargs):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(dataset, "load_token_dataset", no_jsonl)
    second = dataset.init_dataset(cfg, UnitTokeniser())
    assert sorted(first) == sorted(second) == sorted(want) == ["train", "validation"]
    for split in want:
        assert len(want[split]) > 0
        _assert_same(first[split], want[split])
        _assert_same(second[split], want[split])
    assert isinstance(second["train"].tokens, np.memmap)
    batches = _batches(jax_dataset, want["train"])
    _assert_batches(_batches(dataset, first["train"]), batches)
    _assert_batches(_batches(dataset, second["train"]), batches)
    # the JAX package loads the port's cache to the same rows
    jloaded = jax_dataset.init_dataset(Node(data=Node(data), model=Node(context_len=32)), None)
    for split in want:
        _assert_same(jloaded[split], want[split])
