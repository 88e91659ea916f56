"""GenPPL's and the LLM judge's model directories, fabricated offline and
seeded, as `chip_smoke.py` phase 12 and the CPU tests drive them.

  * `write_whisper_dir(folder)` — an `openai/whisper-large-v3-turbo`-shaped
    checkpoint: its config.json (d_model 1280, 32 encoder and 4 decoder
    layers, 20 heads of 64, FFN 5120, 128 mel bins, vocabulary 51866, 1500
    source and 448 target positions), a generation_config.json with the
    forced prefix of English transcription without timestamps
    (`<|en|>`, `<|transcribe|>`, `<|notimestamps|>`) and the checkpoint's
    suppress lists, its preprocessor_config.json, and a byte-level BPE
    tokenizer.json of 50257 entries with Whisper's special and timestamp
    tokens at their real ids (50257 `<|endoftext|>` ... 50365-51865
    `<|0.00|>`-`<|30.00|>`);
  * `write_llama_dir(folder)` — a `meta-llama/Llama-3.2-1B`-shaped text LM:
    its config.json (16 layers, hidden 2048, 32/8 heads of 64, MLP 8192,
    vocabulary 128256, tied embeddings, rope_theta 500000 and the llama3
    `rope_scaling` block) and a byte-level BPE tokenizer.json of 128000
    entries and 256 special tokens (128000 `<|begin_of_text|>`, 128001
    `<|end_of_text|>`) with Llama 3's pre-tokenizer regex;
  * `write_alignments(folder, wavs)` — an alignment JSON of (word, start,
    end) triples for each WAV, for `use_alignment` prompts.

Both models get random weights from `seed`, written as F16 safetensors (half
the bytes of float32), in HF's key layout, so transformers and the JAX
package load the same directories. `tiny=True` keeps every vocabulary and id
at its real value and cuts the widths and depths (and Whisper's 448 target
positions to 48, so a transcript is at most 44 tokens), for the CPU tests. The
BPE merges are random pairs of the growing vocabulary: real ids, random
strings. Nothing here imports transformers, tokenizers or safetensors.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Sequence

import numpy as np

from ..tokeniser.text_tokeniser import _bytes_to_unicode
from ..utils.safetensors import write_safetensors

WHISPER_VOCAB, WHISPER_BPE = 51866, 50257
LLAMA_VOCAB, LLAMA_BPE = 128256, 128000
#: Whisper large-v3's 100 language tokens, in id order from 50259
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no "
    "th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw "
    "gl mr pa si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl "
    "mg as tt haw ln ha ba jw su yue").split()
#: openai/whisper-large-v3-turbo's generation_config.json suppress_tokens
WHISPER_SUPPRESS = [
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63, 90, 91, 92, 93, 359,
    503, 522, 542, 873, 893, 902, 918, 922, 931, 1350, 1853, 1982, 2460, 2627, 3246, 3253,
    3268, 3536, 3846, 3961, 4183, 4667, 6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938,
    12033, 12331, 12562, 13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470, 36865, 42863, 47425,
    49870, 50254, 50258, 50359, 50360, 50361, 50362, 50363]

WHISPER_TURBO = dict(d_model=1280, encoder_layers=32, decoder_layers=4,
                     encoder_attention_heads=20, decoder_attention_heads=20,
                     encoder_ffn_dim=5120, decoder_ffn_dim=5120, num_mel_bins=128)
WHISPER_TINY = dict(d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                    decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64,
                    num_mel_bins=128, max_target_positions=48)
LLAMA_1B = dict(hidden_size=2048, num_hidden_layers=16, num_attention_heads=32,
                num_key_value_heads=8, head_dim=64, intermediate_size=8192)
LLAMA_TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
                  num_key_value_heads=2, head_dim=8, intermediate_size=128)
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def whisper_special_tokens() -> list:
    """(id, content, special) of every Whisper token past the BPE's 50257."""
    names = (["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{c}|>" for c in LANGUAGES]
             + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                "<|nospeech|>", "<|notimestamps|>"])
    out = [(WHISPER_BPE + i, t, True) for i, t in enumerate(names)]
    stamps = [f"<|{0.02 * i:.2f}|>" for i in range(1501)]
    out += [(WHISPER_BPE + len(names) + i, t, False) for i, t in enumerate(stamps)]
    assert out[-1][0] == WHISPER_VOCAB - 1 and out[2][1] == "<|en|>" and out[2][0] == 50259
    return out


def random_bpe(n_entries: int, seed: int) -> tuple:
    """(vocab, merges) of a byte-level BPE with `n_entries` ids: the 256 byte
    symbols, then merges of a random vocabulary token (up to 12 symbols)
    with a random byte symbol, weighted towards letters and the space."""
    table = _bytes_to_unicode()
    base = [table[b] for b in range(256)]
    vocab: Dict[str, int] = {t: i for i, t in enumerate(base)}
    tokens = list(base)
    merges = []
    weights = np.ones(256)
    weights[[ord(c) for c in "abcdefghijklmnopqrstuvwxyz"]] = 40.0
    weights[ord(" ")] = 60.0
    weights[[ord(c) for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ.,'"]] = 6.0
    weights /= weights.sum()
    rng = np.random.default_rng(seed)
    while len(tokens) < n_entries:
        n = 4 * (n_entries - len(tokens))
        lefts = rng.random(n)
        rights = rng.choice(256, size=n, p=weights)
        for u, r in zip(lefts, rights):
            a = tokens[int(u * u * len(tokens))]    # favour the older, shorter tokens
            b = base[r]
            new = a + b
            if len(a) >= 12 or new in vocab:
                continue
            vocab[new] = len(tokens)
            tokens.append(new)
            merges.append(f"{a} {b}")
            if len(tokens) == n_entries:
                break
    return vocab, merges


def _added(entries) -> list:
    return [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": special} for i, t, special in entries]


def write_whisper_tokenizer(folder: pathlib.Path, seed: int = 0) -> None:
    vocab, merges = random_bpe(WHISPER_BPE, seed)
    added = _added(whisper_special_tokens())
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": True, "use_regex": True},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": "", "end_of_word_suffix": "",
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}
    with open(folder / "tokenizer.json", "w") as f:
        json.dump(spec, f, ensure_ascii=False)
    special = {k: "<|endoftext|>" for k in ("bos_token", "eos_token", "unk_token", "pad_token")}
    with open(folder / "tokenizer_config.json", "w") as f:
        json.dump({**special, "add_prefix_space": False, "clean_up_tokenization_spaces": True,
                   "errors": "replace", "model_max_length": 1000000000000000019884624838656,
                   "processor_class": "WhisperProcessor",
                   "tokenizer_class": "WhisperTokenizer"}, f, indent=2)
    with open(folder / "special_tokens_map.json", "w") as f:
        json.dump(special, f, indent=2)


def _normal(rng, shape, std=0.02) -> np.ndarray:
    return (rng.standard_normal(shape, dtype=np.float32) * std).astype(np.float16)


def whisper_state_dict(arch: dict, vocab: int = WHISPER_VOCAB, seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """Random F16 weights in WhisperForConditionalGeneration's key layout
    (proj_out is tied to the decoder's embed_tokens, so it is not written)."""
    rng = np.random.default_rng(seed)
    d, mel = arch["d_model"], arch["num_mel_bins"]
    ones, zeros = np.ones(d, np.float16), np.zeros(d, np.float16)
    sd = {"model.encoder.conv1.weight": _normal(rng, (d, mel, 3)),
          "model.encoder.conv1.bias": zeros,
          "model.encoder.conv2.weight": _normal(rng, (d, d, 3)),
          "model.encoder.conv2.bias": zeros,
          "model.encoder.embed_positions.weight": _normal(rng, (1500, d)),
          "model.encoder.layer_norm.weight": ones, "model.encoder.layer_norm.bias": zeros,
          "model.decoder.embed_tokens.weight": _normal(rng, (vocab, d)),
          "model.decoder.embed_positions.weight": _normal(
              rng, (arch.get("max_target_positions", 448), d)),
          "model.decoder.layer_norm.weight": ones, "model.decoder.layer_norm.bias": zeros}

    def attn(pre):
        for p in ("q", "k", "v", "out"):
            sd[f"{pre}.{p}_proj.weight"] = _normal(rng, (d, d))
            if p != "k":
                sd[f"{pre}.{p}_proj.bias"] = zeros

    for side, n, ffn in (("encoder", arch["encoder_layers"], arch["encoder_ffn_dim"]),
                         ("decoder", arch["decoder_layers"], arch["decoder_ffn_dim"])):
        for i in range(n):
            pre = f"model.{side}.layers.{i}"
            attn(f"{pre}.self_attn")
            norms = ["self_attn_layer_norm", "final_layer_norm"]
            if side == "decoder":
                attn(f"{pre}.encoder_attn")
                norms.append("encoder_attn_layer_norm")
            for name in norms:
                sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = ones, zeros
            sd[f"{pre}.fc1.weight"] = _normal(rng, (ffn, d))
            sd[f"{pre}.fc1.bias"] = np.zeros(ffn, np.float16)
            sd[f"{pre}.fc2.weight"] = _normal(rng, (d, ffn))
            sd[f"{pre}.fc2.bias"] = zeros
    return sd


def write_whisper_dir(folder, tiny: bool = False, seed: int = 0,
                      encoder_layers: int = None) -> str:
    """The Whisper checkpoint directory (see the module's docstring);
    `encoder_layers` cuts the encoder's depth and keeps every width."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    arch = dict(WHISPER_TINY if tiny else WHISPER_TURBO)
    if encoder_layers is not None:
        arch["encoder_layers"] = encoder_layers
    eos, start = 50257, 50258
    config = {"architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper",
              "activation_function": "gelu", "vocab_size": WHISPER_VOCAB,
              "max_source_positions": 1500, "max_target_positions": 448,
              "begin_suppress_tokens": [220, eos], "bos_token_id": eos, "eos_token_id": eos,
              "pad_token_id": eos, "decoder_start_token_id": start, "scale_embedding": False,
              "num_hidden_layers": arch["encoder_layers"], "torch_dtype": "float16", **arch}
    generation = {"begin_suppress_tokens": [220, eos], "bos_token_id": eos,
                  "decoder_start_token_id": start, "eos_token_id": eos, "pad_token_id": eos,
                  "forced_decoder_ids": [[1, 50259], [2, 50360], [3, 50364]],
                  "is_multilingual": True, "max_length": 448, "no_timestamps_token_id": 50364,
                  "prev_sot_token_id": 50362, "suppress_tokens": WHISPER_SUPPRESS,
                  "task_to_id": {"transcribe": 50360, "translate": 50359},
                  "lang_to_id": {f"<|{c}|>": 50259 + i for i, c in enumerate(LANGUAGES)}}
    preprocessor = {"chunk_length": 30, "feature_extractor_type": "WhisperFeatureExtractor",
                    "feature_size": arch["num_mel_bins"], "hop_length": 160, "n_fft": 400,
                    "n_samples": 480000, "nb_max_frames": 3000, "padding_side": "right",
                    "padding_value": 0.0, "processor_class": "WhisperProcessor",
                    "return_attention_mask": False, "sampling_rate": 16000}
    for name, obj in (("config.json", config), ("generation_config.json", generation),
                      ("preprocessor_config.json", preprocessor)):
        with open(folder / name, "w") as f:
            json.dump(obj, f, indent=2)
    write_whisper_tokenizer(folder, seed)
    write_safetensors(str(folder / "model.safetensors"), whisper_state_dict(arch, seed=seed),
                      metadata={"format": "pt"})
    return str(folder)


def write_llama_tokenizer(folder: pathlib.Path, seed: int = 1) -> None:
    vocab, merges = random_bpe(LLAMA_BPE, seed)
    names = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{i}|>" for i in range(LLAMA_VOCAB - LLAMA_BPE - 2)]
    added = _added((LLAMA_BPE + i, t, True) for i, t in enumerate(names))
    bos = {"id": "<|begin_of_text|>", "ids": [LLAMA_BPE], "tokens": ["<|begin_of_text|>"]}
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
                 "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": False}]},
            "post_processor": {"type": "Sequence", "processors": [
                {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
                 "use_regex": True},
                {"type": "TemplateProcessing",
                 "single": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
                            {"Sequence": {"id": "A", "type_id": 0}}],
                 "pair": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
                          {"Sequence": {"id": "A", "type_id": 0}},
                          {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 1}},
                          {"Sequence": {"id": "B", "type_id": 1}}],
                 "special_tokens": {"<|begin_of_text|>": bos}}]},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
            "model": {"type": "BPE", "dropout": None, "unk_token": None,
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                      "vocab": vocab, "merges": merges}}
    with open(folder / "tokenizer.json", "w") as f:
        json.dump(spec, f, ensure_ascii=False)
    special = {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"}
    with open(folder / "tokenizer_config.json", "w") as f:
        json.dump({**special, "clean_up_tokenization_spaces": True,
                   "model_input_names": ["input_ids", "attention_mask"],
                   "model_max_length": 131072,
                   "tokenizer_class": "PreTrainedTokenizerFast"}, f, indent=2)
    with open(folder / "special_tokens_map.json", "w") as f:
        json.dump(special, f, indent=2)


def llama_state_dict(arch: dict, vocab: int = LLAMA_VOCAB, seed: int = 1
                     ) -> Dict[str, np.ndarray]:
    """Random F16 weights in LlamaForCausalLM's key layout with tied
    embeddings (no lm_head)."""
    rng = np.random.default_rng(seed)
    d, hd = arch["hidden_size"], arch["head_dim"]
    q, kv, ffn = arch["num_attention_heads"] * hd, arch["num_key_value_heads"] * hd, \
        arch["intermediate_size"]
    ones = np.ones(d, np.float16)
    sd = {"model.embed_tokens.weight": _normal(rng, (vocab, d)), "model.norm.weight": ones}
    for i in range(arch["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        for name, shape in (("self_attn.q_proj", (q, d)), ("self_attn.k_proj", (kv, d)),
                            ("self_attn.v_proj", (kv, d)), ("self_attn.o_proj", (d, q)),
                            ("mlp.gate_proj", (ffn, d)), ("mlp.up_proj", (ffn, d)),
                            ("mlp.down_proj", (d, ffn))):
            sd[f"{pre}.{name}.weight"] = _normal(rng, shape)
        sd[f"{pre}.input_layernorm.weight"] = ones
        sd[f"{pre}.post_attention_layernorm.weight"] = ones
    return sd


def write_llama_dir(folder, tiny: bool = False, seed: int = 1, num_layers: int = None) -> str:
    """The text LM's directory (see the module's docstring); `num_layers`
    cuts the depth and keeps every width."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    arch = dict(LLAMA_TINY if tiny else LLAMA_1B)
    if num_layers is not None:
        arch["num_hidden_layers"] = num_layers
    config = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "attention_bias": False, "attention_dropout": 0.0, "bos_token_id": LLAMA_BPE,
              "eos_token_id": LLAMA_BPE + 1, "hidden_act": "silu", "initializer_range": 0.02,
              "max_position_embeddings": 131072, "mlp_bias": False, "pretraining_tp": 1,
              "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "tie_word_embeddings": True,
              "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                               "original_max_position_embeddings": 8192,
                               "rope_type": "llama3"},
              "torch_dtype": "float16", "use_cache": True, "vocab_size": LLAMA_VOCAB, **arch}
    with open(folder / "config.json", "w") as f:
        json.dump(config, f, indent=2)
    write_llama_tokenizer(folder, seed)
    write_safetensors(str(folder / "model.safetensors"), llama_state_dict(arch, seed=seed),
                      metadata={"format": "pt"})
    return str(folder)


def write_alignments(folder, wavs: Sequence[str], seconds: Sequence[float], seed: int = 0
                     ) -> str:
    """folder/<stem>.json per WAV: {"aligned_text": [[word, start, end], ...]}
    of words of 0.2-0.6 s covering its `seconds`, as `PromptDataset`'s
    `use_alignment` reads them."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for wav, dur in zip(wavs, seconds):
        words, t = [], 0.0
        while t < dur:
            end = min(dur, t + float(rng.uniform(0.2, 0.6)))
            words.append([f"w{len(words)}", round(t, 3), round(end, 3)])
            t = end
        name = pathlib.Path(wav).name
        with open(folder / (name[:name.find(".")] + ".json"), "w") as f:
            json.dump({"aligned_text": words}, f)
    return str(folder)
