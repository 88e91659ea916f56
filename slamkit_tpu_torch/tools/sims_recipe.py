"""The SIMS recipe's inputs (docs/SIMS.md), fabricated offline and seeded, as
`chip_smoke.py` phase 11 and the CPU tests drive it.

  * `write_base_dir(root)` — a local base directory: a Qwen2.5-0.5B-shaped
    `config.json` and a WordLevel `tokenizer.json` (words `w0`, `w1`, ...
    after `<pad>`, `<s>`, `</s>`, `<unk>`), written as plain JSON in the
    layout `PreTrainedTokenizerFast.save_pretrained` gives it, so no
    tokenizers package is needed; `tiny=True` gives scripts/rehearse_sims.py
    --tiny's 4-layer, 64-wide decoder;
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
    textless layout) for $TEXTLESS_CHECKPOINT_ROOT.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np

SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")
#: Qwen2.5's tokenizer length: 151643 BPE entries and 22 added tokens
QWEN25_VOCAB = 151665
N_UNITS = 500

QWEN25_ARCH = dict(hidden_size=896, num_hidden_layers=24, num_attention_heads=14,
                   num_key_value_heads=2, intermediate_size=4864)
TINY_ARCH = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                 num_key_value_heads=2, intermediate_size=128)


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


def write_base_dir(root, tiny: bool = False, n_entries: int = QWEN25_VOCAB) -> str:
    """root/base: the decoder's config.json (Qwen2.5-0.5B's widths, rope_theta
    10000, tied embeddings; `tiny` for the 4-layer CPU decoder) and its
    WordLevel tokenizer of `n_entries` ids."""
    base = pathlib.Path(root) / "base"
    write_wordlevel_tokenizer(base, n_entries)
    with open(base / "config.json", "w") as f:
        json.dump({"model_type": "qwen2", "max_position_embeddings": 32768,
                   "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
                   "vocab_size": n_entries, **(TINY_ARCH if tiny else QWEN25_ARCH)}, f)
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
