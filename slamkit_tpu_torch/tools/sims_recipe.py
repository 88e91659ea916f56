"""The SIMS recipe's inputs (docs/SIMS.md), fabricated offline and seeded, as
`chip_smoke.py` phase 11 and the CPU tests drive it.

  * `write_base_dir(root)` — a local base directory: a Qwen2.5-0.5B-shaped
    `config.json` and a WordLevel `tokenizer.json` (words `w0`, `w1`, ...
    after `<pad>`, `<s>`, `</s>`, `<unk>`), written as plain JSON in the
    layout `PreTrainedTokenizerFast.save_pretrained` gives it, so no
    tokenizers package is needed; `tiny=True` gives scripts/rehearse_sims.py
    --tiny's 4-layer, 64-wide decoder, `preset="Qwen/Qwen2.5-7B"` SIMS's
    largest scale;
  * `write_corpora(root, n_rows)` — a text-only, an interleaved and a
    speech-only tokens.jsonl of first-order Markov chains over the words and
    the units, as scripts/rehearse_sims.py::gen_corpora builds them;
  * `write_alignments(folder, features)` — an alignment JSON of (word,
    start, end) triples inside each file's duration, for stage 2's
    `meta_path`;
  * `write_cm_triples(folder, n)` — cross-modal StoryCloze triples: a TEXT
    `_mutual.txt` prompt and SPEECH `_correct.wav` / `_incorrect.wav`
    continuations;
  * `write_text_prompts(folder, n)` — single-line `.txt` prompts;
  * `write_textless_vocoder(root, cfg)` — `vocoder=vocoder_hubert_25`'s two
    files (a CodeHiFiGAN of `cfg`'s widths, seeded random weights, in the
    textless layout) for $TEXTLESS_CHECKPOINT_ROOT;
  * `write_gpt2_bpe_files(folder)` — the shipped default text tokeniser's
    layout (`facebook/opt-125m`, config/tokeniser/interleaved_hubert_25.yaml):
    a GPT-2 `vocab.json` of 50265 ids (`<s>`, `<pad>`, `</s>`, `<unk>` at
    0-3, then a seeded byte-level BPE) with its `merges.txt`, OPT's
    `tokenizer_config.json` (GPT2Tokenizer, add_bos_token) and
    `special_tokens_map.json`, and no tokenizer.json;
  * `write_opt125m_base(folder)` — those files beside facebook/opt-125m's
    config.json (config/model/default.yaml's base): `cli.train` reads the
    interleaving text tokeniser from the base model's directory;
  * `write_pythia14m_base(folder)` — config/train_inter_scale.yaml's base,
    `EleutherAI/pythia-14m`: its config.json from the preset's published
    widths and a GPT-NeoX-shaped byte-level tokenizer.json of 50277 ids;
  * `write_pythia1b_base(folder)` — the same recipe scaled to
    `EleutherAI/pythia-1b` (`model.config_args.base_model_name` swapped):
    its published config.json (8 heads of 256) beside the same tokenizer.

Neither BPE needs the tokenizers package: the vocabularies and merges come
from `genppl_recipe.random_bpe` (real sizes and ids, random strings).
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Optional

import numpy as np

from ..models.presets import PRESETS

SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")
#: OPT-125m's vocab.json: its four specials, then 50261 byte-level BPE entries
OPT_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
OPT_VOCAB = 50265
#: GPT-NeoX-20B's tokenizer (pythia's): 50254 BPE entries (two specials
#: among them) and 23 added runs of 24 down to 2 spaces
NEOX_BPE, NEOX_VOCAB = 50254, 50277


_OPT, _PYTHIA = PRESETS["facebook/opt-125m"], PRESETS["EleutherAI/pythia-14m"]


def _hf_widths(p: dict, ffn_key: str = "intermediate_size") -> dict:
    """config.json's width fields of a preset (models/presets.py)."""
    return {"hidden_size": p["hidden_size"], "num_hidden_layers": p["num_layers"],
            "num_attention_heads": p["num_heads"], ffn_key: p["intermediate_size"],
            "vocab_size": p["vocab_size"],
            "max_position_embeddings": p["max_position_embeddings"],
            "tie_word_embeddings": p["tie_word_embeddings"]}


#: facebook/opt-125m's config.json (the preset's published widths)
OPT125M_CONFIG = dict(model_type="opt", architectures=["OPTForCausalLM"],
                      **_hf_widths(_OPT, ffn_key="ffn_dim"), do_layer_norm_before=True,
                      word_embed_proj_dim=_OPT["hidden_size"], activation_function="relu",
                      enable_bias=True, pad_token_id=1, bos_token_id=2, eos_token_id=2,
                      torch_dtype="float16")
#: EleutherAI/pythia-14m's config.json (the preset's published widths)
PYTHIA14M_CONFIG = dict(model_type="gpt_neox", architectures=["GPTNeoXForCausalLM"],
                        **_hf_widths(_PYTHIA), hidden_act="gelu",
                        rotary_pct=_PYTHIA["rotary_pct"], rotary_emb_base=10000,
                        use_parallel_residual=_PYTHIA["parallel_residual"],
                        layer_norm_eps=_PYTHIA["norm_eps"], bos_token_id=0, eos_token_id=0,
                        initializer_range=0.02, torch_dtype="float16")
#: EleutherAI/pythia-1b's config.json as published
#: (huggingface.co/EleutherAI/pythia-1b/config.json): hidden 2048 over 8
#: heads of 256, 16 layers, rotary on a quarter of each head
PYTHIA1B_CONFIG = dict(model_type="gpt_neox", architectures=["GPTNeoXForCausalLM"],
                       hidden_size=2048, num_hidden_layers=16, num_attention_heads=8,
                       intermediate_size=8192, vocab_size=50304, max_position_embeddings=2048,
                       tie_word_embeddings=False, hidden_act="gelu", rotary_pct=0.25,
                       rotary_emb_base=10000, use_parallel_residual=True, layer_norm_eps=1e-5,
                       bos_token_id=0, eos_token_id=0, initializer_range=0.02,
                       torch_dtype="float16")
#: Qwen2.5's tokenizer length: 151643 BPE entries and 22 added tokens
QWEN25_VOCAB = 151665
N_UNITS = 500

QWEN25_ARCH = dict(hidden_size=896, num_hidden_layers=24, num_attention_heads=14,
                   num_key_value_heads=2, intermediate_size=4864)
TINY_ARCH = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                 num_key_value_heads=2, intermediate_size=128)
_QWEN7B = PRESETS["Qwen/Qwen2.5-7B"]
#: Qwen/Qwen2.5-7B's config.json fields (the preset's published widths)
QWEN25_7B_CONFIG = dict(hidden_size=_QWEN7B["hidden_size"],
                        num_hidden_layers=_QWEN7B["num_layers"],
                        num_attention_heads=_QWEN7B["num_heads"],
                        num_key_value_heads=_QWEN7B["num_kv_heads"],
                        intermediate_size=_QWEN7B["intermediate_size"],
                        max_position_embeddings=_QWEN7B["max_position_embeddings"],
                        rope_theta=_QWEN7B["rope_theta"], rms_norm_eps=_QWEN7B["norm_eps"],
                        tie_word_embeddings=_QWEN7B["tie_word_embeddings"])


def write_wordlevel_tokenizer(folder, n_entries: int) -> None:
    """tokenizer.json, tokenizer_config.json and special_tokens_map.json of a
    WordLevel tokenizer with the Whitespace pre-tokenizer: the four special
    tokens, then words `w0`, `w1`, ... up to `n_entries` ids. Its
    model_input_names are Qwen2's (no token_type_ids)."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    vocab = {t: i for i, t in enumerate(SPECIALS)}
    vocab.update({f"w{i}": len(SPECIALS) + i for i in range(n_entries - len(SPECIALS))})
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, t in enumerate(SPECIALS)]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    with open(folder / "tokenizer.json", "w") as f:
        json.dump(spec, f, ensure_ascii=False)
    names = dict(zip(("pad_token", "bos_token", "eos_token", "unk_token"), SPECIALS))
    config = {"added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items() if k != "id"}
                                       for a in added},
              **names, "clean_up_tokenization_spaces": False,
              "model_input_names": ["input_ids", "attention_mask"],
              "model_max_length": 32768, "tokenizer_class": "PreTrainedTokenizerFast"}
    with open(folder / "tokenizer_config.json", "w") as f:
        json.dump(config, f, indent=2)
    with open(folder / "special_tokens_map.json", "w") as f:
        json.dump(names, f, indent=2)


def write_base_dir(root, tiny: bool = False, n_entries: int = QWEN25_VOCAB,
                   preset: Optional[str] = None, arch: Optional[dict] = None) -> str:
    """root/base: the decoder's config.json (Qwen2.5-0.5B's widths, rope_theta
    10000, tied embeddings; `tiny` for the 4-layer CPU decoder; `preset`
    "Qwen/Qwen2.5-7B" for that model's published config: 28 layers of 3584,
    28 / 4 heads, FFN 18944, rope_theta 1e6, untied embeddings; `arch`
    replaces the widths, to cut the depth or rehearse at small widths) and
    its WordLevel tokenizer of `n_entries` ids."""
    base = pathlib.Path(root) / "base"
    write_wordlevel_tokenizer(base, n_entries)
    config = {"model_type": "qwen2", "max_position_embeddings": 32768,
              "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
              **(TINY_ARCH if tiny else QWEN25_ARCH)}
    if preset == "Qwen/Qwen2.5-7B":
        config.update(QWEN25_7B_CONFIG)
    elif preset is not None:
        raise ValueError(f"write_base_dir writes Qwen2.5-0.5B or Qwen/Qwen2.5-7B, not {preset}")
    config.update(arch or {}, vocab_size=n_entries)
    with open(base / "config.json", "w") as f:
        json.dump(config, f)
    return str(base)


def _chains(rng, succ: np.ndarray, lens, starts) -> list:
    """First-order Markov chains, every sequence advancing one step a column
    (4 successors a state)."""
    lens = np.asarray(lens)
    cols = np.empty((int(lens.max()), len(lens)), np.int64)
    states = np.asarray(starts, np.int64).copy()
    draws = rng.integers(0, 4, size=cols.shape)
    for t in range(cols.shape[0]):
        cols[t] = states
        states = succ[states, draws[t]]
    return [cols[:n, i] for i, n in enumerate(lens)]


def write_corpora(root, n_rows: int, lengths=(300, 700), n_words: int = 800,
                  span: int = 50, seed: int = 0) -> list:
    """[text, interleaved, speech] tokens.jsonl paths: `n_rows` rows each of
    `lengths` tokens; words `w<k>` over the first n_words words and units
    follow their own 4-successor chains, and the interleaved rows alternate
    spans of `span` words and units, each opened by its modality token."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    usucc = np.random.default_rng(seed + 12345).integers(0, N_UNITS, (N_UNITS, 4))
    wsucc = np.random.default_rng(seed + 54321).integers(0, n_words, (n_words, 4))
    unit_str = lambda u: "".join(f"<Un{x}>" for x in u)
    word_str = lambda w: " ".join(f"w{x}" for x in w)
    paths = []
    for name in ("text", "inter", "speech"):
        lens = rng.integers(lengths[0], lengths[1], n_rows)
        if name == "speech":
            rows = ["<speech>" + unit_str(s) for s in
                    _chains(rng, usucc, lens, rng.integers(0, N_UNITS, n_rows))]
        elif name == "text":
            rows = ["<text>" + word_str(s) for s in
                    _chains(rng, wsucc, lens, rng.integers(0, n_words, n_rows))]
        else:
            n_spans = int(lens.sum()) // span + n_rows + 2
            upool = _chains(rng, usucc, [span] * n_spans, rng.integers(0, N_UNITS, n_spans))
            wpool = _chains(rng, wsucc, [span] * n_spans, rng.integers(0, n_words, n_spans))
            rows, k = [], 0
            for n in lens:
                mod, parts = int(rng.integers(2)), []
                for _ in range(max(int(n) // span, 1)):
                    parts.append("<speech>" + unit_str(upool[k]) if mod
                                 else "<text>" + word_str(wpool[k]))
                    k, mod = k + 1, mod ^ 1
                rows.append("".join(parts))
        path = root / f"{name}.jsonl"
        with open(path, "w") as f:
            for i, s in enumerate(rows):
                f.write(json.dumps({"file_name": f"{name}_{i}", "audio_repr": s}) + "\n")
        paths.append(str(path))
    return paths


def write_alignments(folder, features_jsonl, unit_duration: float, n_words: int = 800,
                     seed: int = 0) -> str:
    """One `<stem>.json` a features line, {"aligned_text": [[word, start,
    end], ...]}: consecutive words of 0.1-0.6 s covering the file's duration
    (sum of its unit durations x unit_duration)."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(features_jsonl) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for row in rows:
        total = float(np.sum(row["duration"])) * unit_duration
        words, t = [], 0.0
        while t < total:
            end = min(t + float(rng.uniform(0.1, 0.6)), total)
            words.append([f"w{int(rng.integers(n_words))}", round(t, 3), round(end, 3)])
            t = end
        stem = os.path.splitext(os.path.basename(row["file_name"]))[0]
        with open(folder / f"{stem}.json", "w") as f:
            json.dump({"aligned_text": words}, f)
    return str(folder)


def _words(rng, n: int, n_words: int) -> str:
    return " ".join(f"w{int(w)}" for w in rng.integers(0, n_words, n))


def _write_wav(path, rng, seconds: float, sample_rate: int = 16000):
    from ..utils.audio import save_wav

    t = np.arange(int(seconds * sample_rate)) / sample_rate
    wav = 0.3 * np.sin(2 * np.pi * float(rng.uniform(100, 400)) * t) \
        + 0.05 * rng.standard_normal(len(t))
    save_wav(str(path), wav.astype(np.float32), sample_rate)


def write_cm_triples(folder, n: int, seconds=(0.5, 1.5), n_words: int = 800,
                     seed: int = 3) -> str:
    """Cross-modal StoryCloze triples as `CrossModalMetricDataset` reads them
    with a TEXT prompt and SPEECH continuations (subfolder=false):
    `s<i>_mutual.txt`, `s<i>_correct.wav` and `s<i>_incorrect.wav` of
    `seconds`."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        base = folder / f"s{i}"
        (folder / f"s{i}_mutual.txt").write_text(_words(rng, 12, n_words))
        for side in ("correct", "incorrect"):
            _write_wav(f"{base}_{side}.wav", rng, float(rng.uniform(*seconds)))
    return str(folder)


def write_text_prompts(folder, n: int, n_words: int = 800, seed: int = 5) -> str:
    """`p<i>.txt`: one line of 10 words each."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        (folder / f"p{i}.txt").write_text(_words(rng, 10, n_words))
    return str(folder)


def write_textless_vocoder(root, cfg: dict, seed: int = 2) -> str:
    """root/hifigan_lj_mhubert_base_25hz.pt ({'generator': state dict}) and
    its config json: the files `mhubert-base-25hz-kmeans-500-hifigan`
    resolves to."""
    import torch

    from ..vocoder import hifigan
    from ..vocoder.checkpoint_manager import CHECKPOINTS

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    name = "mhubert-base-25hz-kmeans-500-hifigan"
    sd = hifigan.random_state_dict(cfg, seed=seed)
    torch.save({"generator": {k: torch.from_numpy(v) for k, v in sd.items()}},
               root / CHECKPOINTS[name])
    with open(root / CHECKPOINTS[f"{name}-config"], "w") as f:
        json.dump(cfg, f)
    return str(root)


def _shifted_bpe(first_id: int, n_entries: int, seed: int) -> tuple:
    """`random_bpe`'s vocabulary of `n_entries` ids moved up to start at
    `first_id`, and its merges as pairs."""
    from .genppl_recipe import random_bpe

    vocab, merges = random_bpe(n_entries, seed)
    return ({t: first_id + i for t, i in vocab.items()},
            [m.split(" ") for m in merges])


def write_gpt2_bpe_files(folder, n_merges: int = OPT_VOCAB - len(OPT_SPECIALS) - 256,
                         seed: int = 0) -> str:
    """folder/vocab.json, merges.txt, tokenizer_config.json and
    special_tokens_map.json as facebook/opt-125m ships them: `<s>`, `<pad>`,
    `</s>`, `<unk>` at ids 0-3, the 256 byte symbols, `n_merges` seeded
    merges (their parts already in the vocabulary), then where n_merges is
    smaller unreachable entries up to 50265 ids; GPT2Tokenizer with
    bos / eos / unk `</s>`, pad `<pad>`, add_bos_token true and
    add_prefix_space false. No tokenizer.json."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    vocab, merges = _shifted_bpe(len(OPT_SPECIALS), 256 + n_merges, seed)
    vocab.update({t: i for i, t in enumerate(OPT_SPECIALS)})
    for i in range(len(vocab), OPT_VOCAB):
        vocab[f"<fill{i}>"] = i
    assert len(vocab) == OPT_VOCAB == max(vocab.values()) + 1
    with open(folder / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(folder / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    special = {"bos_token": "</s>", "eos_token": "</s>", "unk_token": "</s>",
               "pad_token": "<pad>"}
    with open(folder / "tokenizer_config.json", "w") as f:
        json.dump({"errors": "replace", **special, "add_prefix_space": False,
                   "add_bos_token": True, "model_max_length": 1000000000000000019884624838656,
                   "tokenizer_class": "GPT2Tokenizer"}, f, indent=2)
    with open(folder / "special_tokens_map.json", "w") as f:
        json.dump(special, f, indent=2)
    return str(folder)


def write_opt125m_base(folder, seed: int = 0) -> str:
    """folder/config.json of facebook/opt-125m (`OPT125M_CONFIG`) beside
    `write_gpt2_bpe_files`' tokenizer files."""
    write_gpt2_bpe_files(folder, seed=seed)
    with open(pathlib.Path(folder) / "config.json", "w") as f:
        json.dump(OPT125M_CONFIG, f, indent=2)
    return str(folder)


def write_pythia14m_base(folder, seed: int = 4) -> str:
    """folder/config.json of EleutherAI/pythia-14m (`PYTHIA14M_CONFIG`) and
    its GPT-NeoX-shaped tokenizer (`write_neox_tokenizer`)."""
    return _write_pythia_base(folder, PYTHIA14M_CONFIG, seed)


def write_pythia1b_base(folder, seed: int = 4) -> str:
    """folder/config.json of EleutherAI/pythia-1b (`PYTHIA1B_CONFIG`) and
    the GPT-NeoX-shaped tokenizer of `write_pythia14m_base` (the pythia
    suite shares one). No weights: TWIST falls back to random init."""
    return _write_pythia_base(folder, PYTHIA1B_CONFIG, seed)


def _write_pythia_base(folder, config: dict, seed: int) -> str:
    write_neox_tokenizer(folder, seed)
    with open(pathlib.Path(folder) / "config.json", "w") as f:
        json.dump(config, f, indent=2)
    return str(folder)


def write_neox_tokenizer(folder, seed: int = 4) -> str:
    """folder's GPT-NeoX-shaped tokenizer: a tokenizer.json of
    `<|endoftext|>` and `<|padding|>` at ids 0-1, a seeded byte-level BPE up
    to 50254 ids and 23 added runs of 24 down to 2 spaces (50254-50276);
    NFC, ByteLevel pre-tokenizer, post-processor and decoder; bos / eos /
    unk `<|endoftext|>`, no pad; GPTNeoXTokenizer (no token_type_ids)."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    specials = ["<|endoftext|>", "<|padding|>"]
    vocab, merges = _shifted_bpe(len(specials), NEOX_BPE - len(specials), seed)
    vocab.update({t: i for i, t in enumerate(specials)})
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, t in enumerate(specials)]
    added += [{"id": NEOX_BPE + i, "content": " " * (24 - i), "single_word": False,
               "lstrip": False, "rstrip": False, "normalized": True, "special": False}
              for i in range(NEOX_VOCAB - NEOX_BPE)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                  "use_regex": True}
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "NFC"}, "pre_tokenizer": byte_level,
            "post_processor": byte_level, "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False,
                      "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]}}
    with open(folder / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    special = {k: "<|endoftext|>" for k in ("bos_token", "eos_token", "unk_token")}
    with open(folder / "tokenizer_config.json", "w") as f:
        json.dump({**special, "add_prefix_space": False, "clean_up_tokenization_spaces": False,
                   "model_max_length": 1000000000000000019884624838656,
                   "tokenizer_class": "GPTNeoXTokenizer"}, f, indent=2)
    with open(folder / "special_tokens_map.json", "w") as f:
        json.dump(special, f, indent=2)
    return str(folder)
