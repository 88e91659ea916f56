"""The port's offline data-preparation helpers (`utils/data_prep.py`,
`utils/tts_utils.py`) against the JAX package's, on the cases of
`tests/test_data_prep.py` and `tests/test_misc_units.py`: LibriSpeech
transcripts, aligned meta jsons, the Gopher rules, both train/val splitters,
the spoken SWAG / HellaSwag writers (with a fake `datasets`), the
word-time recovery from a TTS attention track and `FastSpeech2.generate_wav`
with a faked fairseq output: the same results and files, exactly.
"""
import importlib.util
import json
import sys
import types

import numpy as np
import pytest
import torch

import slamkit_tpu.utils.data_prep as jax_dp
import slamkit_tpu.utils.tts_utils as jax_tts
import slamkit_tpu_torch.utils.data_prep as dp
import slamkit_tpu_torch.utils.tts_utils as tts

MODS = [(dp, "port"), (jax_dp, "jax")]


def _both(fn_name, make_args):
    """fn_name of both packages on fresh arguments: their results."""
    return [getattr(mod, fn_name)(*make_args(tag)) for mod, tag in MODS]


def test_parse_ls_text(tmp_path):
    d = tmp_path / "LibriSpeech" / "1" / "2"
    d.mkdir(parents=True)
    (d / "1-2.trans.txt").write_text("1-2-0001 HELLO WORLD\n1-2-0002 GOOD DAY FRIEND\n")
    (d / "1-3.trans.txt").write_text("1-3-0001 ANOTHER  LINE\n")
    got, want = _both("parse_ls_text", lambda _: (str(tmp_path),))
    assert got == want == {"1-2-0001": "hello world", "1-2-0002": "good day friend",
                           "1-3-0001": "another line"}


def test_parse_transcriptions(tmp_path):
    data = {str(tmp_path / "a.wav"): [{"word": "hi", "start": 0.0, "end": 0.4},
                                      {"word": " there", "start": 0.4, "end": 0.9}],
            str(tmp_path / "sub" / "b.flac"): [{"word": "yo", "start": 0.1, "end": 0.2}]}
    (tmp_path / "alignments.json").write_text(json.dumps(data))
    for _, tag in MODS:
        (tmp_path / tag).mkdir()
    _both("parse_transcriptions",
          lambda tag: (str(tmp_path / "alignments.json"), str(tmp_path / tag)))
    for name in ("a.json", "b.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert json.loads((tmp_path / "port" / "a.json").read_text())["text"] == "hi there"


def _signals(**over):
    base = {"rps_doc_word_count": [[0, 0, 500]], "rps_doc_mean_word_length": [[0, 0, 5.0]],
            "rps_doc_symbol_to_word_ratio": [[0, 0, 0.01]], "ccnet_nlines": [[0, 0, 10]],
            "rps_lines_start_with_bulletpoint": [[0, 0, 0]],
            "rps_doc_frac_chars_top_2gram": [[0, 0, 0.05]]}
    base.update(over)
    return {"quality_signals": json.dumps(base)}


@pytest.mark.parametrize("over", [
    {}, {"rps_doc_word_count": [[0, 0, 10]]}, {"rps_doc_word_count": [[0, 0, 200000]]},
    {"rps_doc_mean_word_length": [[0, 0, 14.0]]}, {"rps_doc_mean_word_length": [[0, 0, 2.0]]},
    {"rps_doc_symbol_to_word_ratio": [[0, 0, 0.5]]},
    {"rps_lines_start_with_bulletpoint": [[0, 0, 1]] * 10},
    {"rps_doc_frac_chars_top_2gram": [[0, 0, 0.5]]}])
def test_gopher_rules(over):
    got, want = _both("gopher_rules_pass", lambda _: (_signals(**over),))
    assert got == want == (not over)


def test_train_val_split(tmp_path):
    for _, tag in MODS:
        with open(tmp_path / f"{tag}.json", "w") as f:
            for i in range(200):
                f.write(json.dumps({"file_name": f"f{i}"}) + "\n")
    _both("train_val_split", lambda tag: (str(tmp_path / f"{tag}.json"), 0.1, 3))
    for part in ("val", "train"):
        assert (tmp_path / f"port_{part}.json").read_text() == \
            (tmp_path / f"jax_{part}.json").read_text()
    assert 0 < len((tmp_path / "port_val.json").read_text().splitlines()) < 60


def test_split_repr_file(tmp_path):
    val_path = tmp_path / "val_list.json"
    with open(val_path, "w") as f:
        for i in (1, 4):
            f.write(json.dumps({"file_name": f"/y/librilight-vad/part{i}.flac"}) + "\n")
    for _, tag in MODS:
        with open(tmp_path / f"{tag}.json", "w") as f:
            for i in range(6):
                f.write(json.dumps({"file_name": f"/x/librilight-vad/part{i}.flac"}) + "\n")
    _both("split_repr_file", lambda tag: (str(tmp_path / f"{tag}.json"), str(val_path)))
    for part in ("val", "train"):
        assert (tmp_path / f"port_{part}.json").read_text() == \
            (tmp_path / f"jax_{part}.json").read_text()
    assert len((tmp_path / "port_val.json").read_text().splitlines()) == 2


def test_spoken_datasets_write_distinct_files(tmp_path, monkeypatch):
    class FakeDS(list):
        def filter(self, fn):
            return self

        def map(self, fn):
            return self

        def remove_columns(self, cols):
            return self

        def select(self, r):
            return self

    fake = types.ModuleType("datasets")
    fake.load_dataset = lambda *a, **k: FakeDS()
    monkeypatch.setitem(sys.modules, "datasets", fake)
    written = {}
    for mod, tag in MODS:
        monkeypatch.setattr(mod, "_synthesise_split",
                            lambda ds, sp, out, name, tag=tag: written.setdefault(tag, []).append(name))
        mod.create_spoken_swag("x", str(tmp_path))
        mod.create_spoken_hellaswag("x", str(tmp_path))
    assert written["port"] == written["jax"] == ["spoken_swag_validation.jsonl",
                                                 "spoken_hellaswag_validation.jsonl"]
    assert dp.SPEAKERS == jax_dp.SPEAKERS


def test_tts_alignment_equals_jax():
    rng = np.random.default_rng(0)
    cases = [(np.array([0, 0, 1, 1, 1, 2, 2, 3, 3, 3, 4, 4, 5, 5, 5]), [2, 3], ["hi", "there"],
              16000),
             (np.repeat(np.arange(9), rng.integers(1, 5, 9)), [3, 1, 4], ["a", "b", "c"], 22050),
             (np.array([0, 1, 1, 3]), [2, 1], ["ab", "c"], 16000)]
    for track, counts, words, sr in cases:
        got = tts.attention_to_word_times(track, counts, words, sr)
        assert got == jax_tts.attention_to_word_times(track, counts, words, sr)
    assert tts.attention_to_word_times(*cases[0][:3], 16000)[0] == \
        (" hi", round(2 * 256 / 16000, 3), round(6 * 256 / 16000, 3))
    raw = ["HH", "AY1", ",", ";", "!", "sp", "a-b"]
    assert tts.clean_phonemes(raw) == jax_tts.clean_phonemes(raw) == \
        ["HH", "AY1", "sp", "sp", "sp"]
    for mod in (tts, jax_tts):
        with pytest.raises(ValueError, match="no frame attends"):
            mod.attention_to_word_times(np.array([0, 9]), [1], ["x"], 16000)


def test_tts_generate_wav_with_faked_fairseq(monkeypatch):
    track = np.array([0, 1, 1, 2, 2, 2, 3, 4, 4])
    fake_out = [{"attn": torch.tensor(track), "wav": torch.zeros(9 * 256)}]
    spans = []
    for mod in (tts, jax_tts):
        fs2 = mod.FastSpeech2.__new__(mod.FastSpeech2)
        fs2.sr = 22050
        fs2.g2p = lambda w: {"hey": ["HH", "EY1", "!"], "you": ["Y", "UW1"]}[w]
        monkeypatch.setattr(mod.FastSpeech2, "_synthesize", lambda self, text: fake_out)
        assert fs2.generate_wav("hey you", alignment=False) is fake_out
        out, sp = fs2.generate_wav("hey you", alignment=True)
        assert out is fake_out
        spans.append(sp)
    assert spans[0] == spans[1] == [
        (" hey", round(1 * 256 / 22050, 3), round(5 * 256 / 22050, 3)),
        (" you", round(6 * 256 / 22050, 3), round(8 * 256 / 22050, 3))]


def test_tts_models_need_their_packages():
    """Importing the module needs none of kokoro, g2p_en or fairseq; a call
    raises where its package is absent."""
    for package, call in (("kokoro", lambda: tts.kokoro(["hi"])),
                          ("g2p_en", lambda: tts.FastSpeech2(device="cpu"))):
        if importlib.util.find_spec(package) is None:
            with pytest.raises(ImportError, match=package):
                call()
