"""The port's copies of the numpy data path, the unit tokeniser's string side
and the trainer callbacks, held equal to the JAX package's originals: batches
bit for bit (pad, greedy and best-fit packing with the row permutation,
skip_batches, several epochs, slab boundaries), packer assignments, jsonl
loading with chunking and filters, tokeniser ids, and the stoppers' flags.
"""
import json

import numpy as np
import pytest

import slamkit_tpu.data.dataset as jax_dataset
import slamkit_tpu.native.pack as jax_pack
import slamkit_tpu.trainer.callbacks as jax_callbacks
from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu.tokeniser.unit_tokeniser import pad_token_batch as jax_pad_token_batch
import slamkit_tpu_torch.data.dataset as dataset
import slamkit_tpu_torch.trainer.callbacks as callbacks
from slamkit_tpu_torch.data import pack
from slamkit_tpu_torch.tokeniser import UnitTokeniser, pad_token_batch


def _seqs(seed, n, lo=1, hi=40, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(lo, hi))).tolist() for _ in range(n)]


@pytest.mark.parametrize("slab", [1 << 18, 23])
@pytest.mark.parametrize("packing,strategy", [(False, "bestfit"), (True, "greedy"),
                                              (True, "bestfit")])
def test_batches_equal_jax_bit_for_bit(monkeypatch, slab, packing, strategy):
    """Two epochs and a resumed stream (skip_batches) of every mode; a slab
    of 23 sequences crosses slab boundaries inside rows and batches."""
    monkeypatch.setattr(jax_dataset, "_SLAB", slab)
    monkeypatch.setattr(dataset, "_SLAB", slab)
    seqs = _seqs(0, 150)
    seqs[5] = []                                   # zero-length rows place nothing
    mk = lambda mod: mod.Batcher(mod.TokenDataset.from_lists(seqs), 4, 32, pad_id=0,
                                 packing=packing, shuffle=True, seed=3,
                                 packing_strategy=strategy)
    want, got = mk(jax_dataset), mk(dataset)
    assert got.batches_per_epoch() == want.batches_per_epoch()
    for epoch, skip in ((0, 0), (1, 0), (1, 3)):
        a = list(want.epoch(epoch, skip_batches=skip))
        b = list(got.epoch(epoch, skip_batches=skip))
        assert len(a) == len(b) > 0
        for i, (x, y) in enumerate(zip(a, b)):
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(y[k], x[k], err_msg=f"{epoch}/{skip}/{i}/{k}")
                assert np.asarray(y[k]).dtype == np.asarray(x[k]).dtype, k


def test_packers_equal_native():
    rng = np.random.default_rng(1)
    lens = rng.integers(0, 50, 500)
    for t in (50, 64, 128):
        want_r, want_c, want_n = jax_pack.bestfit_pack(lens, t)
        got_r, got_c, got_n = pack.bestfit_pack(lens, t)
        assert got_n == want_n
        np.testing.assert_array_equal(got_r, want_r)
        np.testing.assert_array_equal(got_c, want_c)
        for a, b in zip(pack.greedy_pack(lens, t, 3, 11), jax_pack.greedy_pack(lens, t, 3, 11)):
            np.testing.assert_array_equal(a, b)
        assert pack.greedy_pack_count(lens, t) == jax_pack.greedy_pack_count(lens, t)


def test_jsonl_loading_chunks_and_filters_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    for name, n in (("train", 40), ("val", 7)):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            for i in range(n):
                units = rng.integers(0, 500, int(rng.integers(1, 90)))
                f.write(json.dumps({"file_name": f"{name}{i}",
                                    "audio_repr": "".join(f"<Un{u}>" for u in units)}) + "\n")
    cfg = {"data": {"sample_units_max_length": 80, "chunk_units_min_length": 5},
           "model": {"context_len": 32}}

    class Node(dict):   # the JAX function reads attributes as well as keys
        __getattr__ = dict.__getitem__

    jax_cfg = Node(data=Node(cfg["data"]), model=Node(cfg["model"]))
    want = jax_dataset.parse_single_dataset(jax_cfg, JaxUnitTokeniser(load_fe=False),
                                            str(tmp_path / "train.jsonl"),
                                            str(tmp_path / "val.jsonl"))
    got = dataset.parse_single_dataset(cfg, UnitTokeniser(), str(tmp_path / "train.jsonl"),
                                       str(tmp_path / "val.jsonl"))
    assert sorted(got) == sorted(want) == ["train", "validation"]
    for k in want:
        assert len(got[k]) == len(want[k])
        for i in range(len(want[k])):
            np.testing.assert_array_equal(got[k][i], want[k][i])
    assert got["train"].token_stats() == want["train"].token_stats()


def test_tokeniser_ids_equal_jax():
    rng = np.random.default_rng(4)
    reprs = ["".join(f"<Un{u}>" for u in rng.integers(0, 500, n)) for n in (5, 17, 0, 9)]
    want, got = JaxUnitTokeniser(load_fe=False), UnitTokeniser()
    assert len(got) == len(want.text_tokeniser) == 502
    rows = [{"audio_repr": r} for r in reprs]
    assert got.prepare_batch(rows) == want.prepare_batch(rows)
    for padding in (False, True):
        for special in (False, True):
            a = want.string_tokenise(reprs, padding=padding, add_special_tokens=special)
            b = got.string_tokenise(reprs, padding=padding, add_special_tokens=special)
            for k in a:
                if padding:
                    np.testing.assert_array_equal(b[k], a[k])
                else:
                    assert b[k] == a[k]
    prompts = jax_pad_token_batch([want._encode_one(s)[:-1] for s in reprs], 0, "left")
    for k, v in got.prompt_tokenise(reprs).items():
        np.testing.assert_array_equal(v, prompts[k])
    seqs = [[3, 4], [5], []]
    for side in ("left", "right"):
        for k, v in pad_token_batch(seqs, 0, side).items():
            np.testing.assert_array_equal(v, jax_pad_token_batch(seqs, 0, side)[k])


def test_callbacks_behave_like_jax():
    for rt in (90, "0:01:30", "1-00:00:10"):
        assert callbacks.parse_run_time(rt) == jax_callbacks.parse_run_time(rt)
    for mod in (callbacks, jax_callbacks):
        state, control = mod.TrainerState(), mod.TrainerControl()
        cb = mod.MaxTokensStopperCallback(1000)
        cb.on_train_begin(None, state, control)
        state.num_input_tokens_seen = 999
        cb.on_step_end(None, state, control)
        assert not control.should_training_stop
        state.num_input_tokens_seen = 1000
        cb.on_step_end(None, state, control)
        assert control.should_training_stop and control.should_save and control.should_evaluate
        state, control = mod.TrainerState(), mod.TrainerControl()
        rt = mod.RunTimeStopperCallback(0)
        rt.on_train_begin(None, state, control)
        rt.start_time -= 1.0
        rt.on_step_end(None, state, control)
        assert control.should_training_stop and control.should_save
    fields = lambda cls: [(f.name, f.default) for f in cls.__dataclass_fields__.values()]
    assert fields(callbacks.TrainerState) == fields(jax_callbacks.TrainerState)
    assert fields(callbacks.TrainerControl) == fields(jax_callbacks.TrainerControl)
