"""The port's tokenizer.json reader (`slamkit_tpu_torch/tokeniser/text_tokeniser.py`)
against `transformers.AutoTokenizer` on the same local directory.

Three tokenizers are trained offline with the tokenizers library on a seeded
corpus and saved through `PreTrainedTokenizerFast.save_pretrained`, and a
fourth is written without it:
  * WordLevel + the Whitespace pre-tokenizer (what scripts/rehearse_sims.py
    and the JAX package's tests build);
  * byte-level BPE with the GPT-2 regex and an OPT-style post-processor that
    prepends `</s>`;
  * Qwen2-style: an NFC normalizer, the Split regex, then ByteLevel without
    its regex;
  * the WordLevel tokenizer that `tools/sims_recipe.py` writes as plain JSON
    (words `w0`, `w1`, ...), as the smoke's base directory holds it;
  * GPT-2 slow-tokenizer files without tokenizer.json, as facebook/opt-125m
    (config/tokeniser/interleaved_hubert_25.yaml's default) ships them: a
    byte-level BPE trained here and saved by `models.BPE.save` as vocab.json
    + merges.txt, with OPT's specials (`<s>`, `<pad>`, `</s>`, `<unk>` at
    0-3; bos / eos / unk `</s>`, pad `<pad>`), an `additional_special_tokens`
    entry and an added_tokens.json, under OPT's tokenizer_config.json
    (`add_bos_token` true, `add_prefix_space` false) and its reverse (false,
    true); transformers converts them with `GPT2Converter`;
  * what `tools/sims_recipe.py` writes for the smoke's phase 16:
    `write_gpt2_bpe_files` (OPT-shaped files of 50265 ids; 20000 merges
    here, the rest of the ids unreachable) and
    `write_pythia14m_base`'s GPT-NeoX-shaped tokenizer.json (50277 ids,
    added runs of spaces).
Both sides then take the interleaving tokeniser's steps (pad id 0, the unit,
`<speech>` and `<text>` tokens added) and must agree exactly on ids,
attention masks, right and left padding, `len`, `convert_tokens_to_ids`, the
special ids and `decode`, on seeded strings holding added tokens with and
without spaces around them, digits, punctuation and non-ASCII letters.
"""
import numpy as np
import pytest

from slamkit_tpu_torch.tokeniser.text_tokeniser import TextTokeniser

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

N_UNITS = 40
QWEN_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+"
              r"[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
WORDS = ["the", "cat", "sat", "on", "a", "mat", "café", "naïve", "straße", "Ελλάδα", "мир",
         "12", "345", "7", "don't", "it's", "hello,", "world!", "x_y", "ü", "9th", "—"]


def _corpus(seed=0, n=400):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(4, 16)))) for _ in range(n)]


def _strings(seed=1, n=24):
    """Seeded strings as the interleaving tokeniser builds them, plus
    spaces, digits and words the tokenizer never saw."""
    rng = np.random.default_rng(seed)
    # combining marks, other numbers, the joiner, an Other_Alphabetic symbol
    # and U+001C, where Python's \w and \s differ from the tokenizers library's
    extra = WORDS + ["Zebra", "ŝ", "١٢", "2024", "  ", "\t", "?!", "w7", "w299", "w300",
                     "cafe\u0301", "a²b", "a\u200db", "Ⓐb", "a\x1cb", "\U00016E80x",
                     "x\u3000y", "Ⅷ"]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(2, 9))):
            kind = rng.integers(4)
            if kind == 0:
                parts.append("<speech>" + "".join(f"<Un{u}>" for u in
                                                  rng.integers(0, N_UNITS, rng.integers(1, 5))))
            elif kind == 1:
                parts.append("<text>" + " ".join(rng.choice(extra, rng.integers(1, 4))))
            elif kind == 2:
                parts.append(f" <Un{int(rng.integers(N_UNITS))}> ")
            else:
                parts.append(str(rng.choice(extra)))
        out.append("".join(parts))
    out += ["<Un17>", "<speech> <Un17><Un1>  <text> café 12 345", "", " ", "don't STOP 99",
            " ".join(extra[len(WORDS):])]
    return out


def _build(kind, root):
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers,
                            processors, trainers)
    from transformers import PreTrainedTokenizerFast

    corpus = _corpus()
    if kind == "written":
        from slamkit_tpu_torch.tools.sims_recipe import write_wordlevel_tokenizer

        write_wordlevel_tokenizer(root / kind, 300)
        return str(root / kind)
    if kind == "gpt2_written":     # 20000 merges, then unreachable entries to 50265 ids
        from slamkit_tpu_torch.tools.sims_recipe import write_gpt2_bpe_files

        return write_gpt2_bpe_files(root / kind, n_merges=20000)
    if kind == "neox_written":
        from slamkit_tpu_torch.tools.sims_recipe import write_pythia14m_base

        return write_pythia14m_base(root / kind)
    if kind.startswith("gpt2_files"):
        return _gpt2_files(root / kind, corpus, prefix=kind.endswith("prefix"))
    if kind == "wordlevel":
        tok = Tokenizer(models.WordLevel(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        tok.train_from_iterator(corpus, trainers.WordLevelTrainer(
            special_tokens=["<pad>", "<s>", "</s>", "<unk>"]))
        specials = dict(pad_token="<pad>", bos_token="<s>", eos_token="</s>", unk_token="<unk>")
    elif kind == "opt_bpe":
        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        tok.train_from_iterator(corpus, trainers.BpeTrainer(
            vocab_size=420, special_tokens=["<pad>", "</s>", "<unk>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        eos = tok.token_to_id("</s>")
        tok.post_processor = processors.TemplateProcessing(
            single="</s> $A", pair="</s> $A </s> $B", special_tokens=[("</s>", eos)])
        specials = dict(pad_token="<pad>", bos_token="</s>", eos_token="</s>", unk_token="<unk>")
    else:
        tok = Tokenizer(models.BPE())
        tok.normalizer = normalizers.NFC()
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(QWEN_SPLIT), behavior="isolated", invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
        tok.decoder = decoders.ByteLevel()
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
        tok.train_from_iterator(corpus, trainers.BpeTrainer(
            vocab_size=420, special_tokens=["<|endoftext|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        specials = dict(pad_token="<|endoftext|>", eos_token="<|endoftext|>")
    d = root / kind
    PreTrainedTokenizerFast(tokenizer_object=tok, **specials).save_pretrained(str(d))
    return str(d)


def _gpt2_files(d, corpus, prefix: bool):
    """vocab.json + merges.txt of a byte-level BPE trained on `corpus` (no
    tokenizer.json), OPT's special tokens, one additional special token and
    two entries of added_tokens.json; `prefix`: add_bos_token false and
    add_prefix_space true (OPT's are true and false)."""
    import json

    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=prefix)
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=420, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    d.mkdir()
    tok.model.save(str(d))
    assert sorted(p.name for p in d.iterdir()) == ["merges.txt", "vocab.json"]
    n = tok.get_vocab_size()
    special = dict(bos_token="</s>", eos_token="</s>", unk_token="</s>", pad_token="<pad>")
    as_added = lambda t: {"content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": True, "__type": "AddedToken"}
    (d / "tokenizer_config.json").write_text(json.dumps({
        "errors": "replace", **{k: as_added(v) for k, v in special.items()},
        "add_prefix_space": prefix, "add_bos_token": not prefix,
        "additional_special_tokens": ["<extra_id_0>"], "tokenizer_class": "GPT2Tokenizer"}))
    (d / "special_tokens_map.json").write_text(json.dumps(special))
    (d / "added_tokens.json").write_text(json.dumps({"<sep>": n, "café!": n + 1}))
    return str(d)


@pytest.fixture(scope="module", params=["wordlevel", "opt_bpe", "qwen2_bpe", "written",
                                        "gpt2_files", "gpt2_files_prefix", "gpt2_written",
                                        "neox_written"])
def pair(request, tmp_path_factory):
    """(port, transformers) on one directory, both extended as the
    interleaving tokeniser extends them."""
    from transformers import AutoTokenizer

    path = _build(request.param, tmp_path_factory.mktemp("tok"))
    added = [f"<Un{x}>" for x in range(N_UNITS)] + ["<speech>", "<text>"]
    ref = AutoTokenizer.from_pretrained(path)
    port = TextTokeniser.from_pretrained(path)
    assert len(port) == len(ref)
    for t in (ref, port):
        t.pad_token_id = 0
        t.padding_side = "right"
        t.add_tokens(added)
    return port, ref


def test_vocabulary_and_special_ids(pair):
    port, ref = pair
    assert len(port) == len(ref)
    names = ["<Un0>", "<Un17>", f"<Un{N_UNITS - 1}>", "<speech>", "<text>", "<pad>", "</s>",
             "the", "café", "never-seen"]
    assert port.convert_tokens_to_ids(names) == ref.convert_tokens_to_ids(names)
    for key in ("pad_token_id", "bos_token_id", "eos_token_id", "unk_token_id"):
        assert getattr(port, key) == getattr(ref, key), key
    assert port.add_tokens(["<speech>", "<Un3>"]) == ref.add_tokens(["<speech>", "<Un3>"]) == 0


@pytest.mark.parametrize("side", ["right", "left"])
def test_batch_ids_masks_and_padding(pair, side):
    port, ref = pair
    strings = _strings()
    got = port(strings, add_special_tokens=True, padding=True, return_tensors="np",
               padding_side=side)
    want = ref(strings, add_special_tokens=True, padding=True, return_tensors="np",
               padding_side=side)
    assert sorted(got) == sorted(want.keys())
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("special", [True, False])
def test_unpadded_lists_and_single_strings(pair, special):
    port, ref = pair
    strings = _strings(seed=2)
    assert port(strings, add_special_tokens=special)["input_ids"] == \
        ref(strings, add_special_tokens=special)["input_ids"]
    for s in strings[:6]:
        assert port(s, add_special_tokens=special)["input_ids"] == \
            ref(s, add_special_tokens=special)["input_ids"]
        np.testing.assert_array_equal(port(s, return_tensors="np")["input_ids"],
                                      ref(s, return_tensors="np")["input_ids"])


@pytest.mark.parametrize("clean", [None, True])
def test_decode(pair, clean):
    port, ref = pair
    for s in _strings(seed=3):
        ids = ref(s, add_special_tokens=True)["input_ids"]
        for skip in (False, True):
            assert port.decode(np.asarray(ids), skip_special_tokens=skip,
                               clean_up_tokenization_spaces=clean) == \
                ref.decode(ids, skip_special_tokens=skip, clean_up_tokenization_spaces=clean)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, len(ref), 64).tolist()
    assert port.decode(ids) == ref.decode(ids)


def test_missing_directory_names_the_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        TextTokeniser.from_pretrained(str(tmp_path))
    (tmp_path / "vocab.json").write_text("{}")        # merges.txt missing
    with pytest.raises(FileNotFoundError, match="vocab.json and merges.txt"):
        TextTokeniser.from_pretrained(str(tmp_path))


def test_unsupported_component_raises():
    spec = {"model": {"type": "Unigram", "vocab": []}}
    with pytest.raises(NotImplementedError, match="Unigram"):
        TextTokeniser(spec)
