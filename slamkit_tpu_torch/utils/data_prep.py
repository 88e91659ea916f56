"""Offline dataset-preparation helpers.

A copy of `slamkit_tpu/utils/data_prep.py`: LibriSpeech transcript parsing
(`parse_ls_text` :18), aligned-transcription meta jsons
(`parse_transcriptions` :31), the Gopher rules over RedPajama quality
signals (`gopher_rules_pass` :46), the train/val splitters
(`split_repr_file` :84, `train_val_split` :100), and the parts built on HF
`datasets` and Kokoro TTS (`parse_red_pajama` :66, the spoken SWAG /
HellaSwag DPO sets :112-193), which import those packages when called and
raise where they are absent.
"""
from __future__ import annotations

import json
import os
import random
from glob import iglob
from pathlib import Path


def parse_ls_text(data_path, ext="trans.txt"):
    """LibriSpeech transcripts -> {utterance_id: text} (reference :8-18).
    Joins with os.path.join — the reference's bare `data_path + '**/...'`
    silently stops recursing when data_path lacks a trailing slash."""
    out = {}
    for file in iglob(os.path.join(data_path, f"**/*.{ext}"), recursive=True):
        with open(file) as f:
            for line in f:
                parts = line.split()
                out[parts[0]] = " ".join(parts[1:]).lower()
    return out


def parse_transcriptions(data_path, out_path=None):
    """Aligned-transcription json -> per-file meta json with aligned_text
    triples (reference :20-29)."""
    with open(data_path) as f_in:
        data = json.load(f_in)
    for k, v in data.items():
        meta_file = f"{out_path}/{Path(k).stem}" if out_path else os.path.splitext(k)[0]
        meta_file += ".json"
        out = {"file_name": k,
               "aligned_text": [tuple(w.values()) for w in v],
               "text": "".join(w["word"] for w in v)}
        with open(meta_file, "w") as f_out:
            json.dump(out, f_out)


def gopher_rules_pass(sample) -> bool:
    """Gopher quality rules over RedPajama quality signals (reference :31-64)."""
    signals = json.loads(sample["quality_signals"])
    word_count = signals["rps_doc_word_count"][0][2]
    if word_count < 50 or word_count > 100_000:
        return False
    mean_word_length = signals["rps_doc_mean_word_length"][0][2]
    if mean_word_length < 3 or mean_word_length > 10:
        return False
    if signals["rps_doc_symbol_to_word_ratio"][0][2] > 0.1:
        return False
    n_lines = signals["ccnet_nlines"][0][2]
    n_bullet = sum(ln[2] for ln in signals["rps_lines_start_with_bulletpoint"])
    if n_bullet / n_lines > 0.9:
        return False
    if signals["rps_doc_frac_chars_top_2gram"][0][2] > 0.2:
        return False
    return True


def parse_red_pajama(out_dir, snapshot="2023-14"):
    """RedPajama-V2 stream -> Gopher-filtered `audio_repr` jsonl
    (text rows reuse the audio training format, reference :67-88)."""
    from datasets import load_dataset

    ds_iterator = load_dataset("togethercomputer/RedPajama-Data-V2",
                               snapshots=[snapshot], languages=["en"],
                               name="default", streaming=True,
                               trust_remote_code=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(f"{out_dir}/{snapshot}-en.jsonl", "a+") as f_out:
        for sample in ds_iterator["train"]:
            if not gopher_rules_pass(sample):
                continue
            f_out.write(json.dumps({"file_name": sample["doc_id"],
                                    "audio_repr": sample["raw_content"]}) + "\n")


def split_repr_file(repr_path, val_path):
    """Split by membership in a given val file list (reference :91-105)."""
    with open(val_path) as f_val:
        val_data = {json.loads(l)["file_name"].split("librilight-vad")[-1]
                    for l in f_val}
    with open(repr_path.replace(".json", "_val.json"), "w") as out_val, \
            open(repr_path.replace(".json", "_train.json"), "w") as out_train, \
            open(repr_path) as f_in:
        for line in f_in:
            data = json.loads(line)
            if data["file_name"].split("librilight-vad")[-1] in val_data:
                out_val.write(line)
            else:
                out_train.write(line)


def train_val_split(data_path, val_size=0.01, seed=None):
    """Streaming approximate split (reference :107-121; unlike the reference,
    seed=0 is honored — `if seed:` there treats 0 as unseeded)."""
    if seed is not None:
        random.seed(seed)
    with open(data_path.replace(".json", "_val.json"), "w") as out_val, \
            open(data_path.replace(".json", "_train.json"), "w") as out_train, \
            open(data_path) as f_in:
        for line in f_in:
            (out_val if random.random() < val_size else out_train).write(line)


def _synthesise_split(ds, speakers, out_path, jsonl_name):
    """Write metadata jsonl + synthesise prompt/chosen/rejected audio with
    Kokoro (reference :152-176, 212-228)."""
    os.makedirs(out_path, exist_ok=True)
    with open(f"{out_path}/{jsonl_name}", "w") as out:
        for sample in ds:
            out.write(json.dumps(sample) + "\n")
    from .tts_utils import kokoro
    from .audio import save_wav

    os.makedirs(f"{out_path}/audio", exist_ok=True)
    for s in speakers:
        cur = [x for x in ds if x["speaker"] == s]
        for sub in ["prompt", "chosen", "rejected"]:
            texts = [x[sub + "_text"] for x in cur]
            paths = [x[sub + "_path"] for x in cur]
            for i, (_, _, audio) in enumerate(kokoro(texts=texts, voice=s)):
                save_wav(paths[i], audio, 24000)


SPEAKERS = ["af_heart", "am_fenrir", "bf_emma", "bm_george"]


def create_spoken_swag(hf_name: str, out_path: str, num_samples=None,
                       split="validation"):
    """Spoken SWAG DPO set via TTS (reference :124-176)."""
    from datasets import load_dataset

    ds = load_dataset(hf_name, split=split)
    ds = ds.filter(lambda x: x["gold-source"] == "gold")
    ds = ds.map(lambda x: {"speaker": random.choice(SPEAKERS), **x})

    def select_pos_neg(sample):
        pos_label = sample["label"]
        neg_label = random.choice(list(set(range(4)) - {pos_label}))
        pos = sample["sent2"] + " " + sample[f"ending{pos_label}"]
        neg = sample["sent2"] + " " + sample[f"ending{neg_label}"]
        base = (f"{out_path}/audio/" + sample["video-id"] + "_"
                + sample["fold-ind"] + "_" + sample["speaker"])
        return {"prompt_text": sample["sent1"], "chosen_text": pos,
                "rejected_text": neg, "prompt_path": f"{base}_prompt.wav",
                "chosen_path": f"{base}_chosen.wav",
                "rejected_path": f"{base}_rejected.wav"}

    ds = ds.map(select_pos_neg)
    ds = ds.remove_columns(["video-id", "fold-ind", "sent1", "sent2", "ending0",
                            "ending1", "ending2", "ending3", "label",
                            "gold-source", "startphrase"])
    if num_samples:
        ds = ds.select(range(num_samples))
    _synthesise_split(list(ds), SPEAKERS, out_path, f"spoken_swag_{split}.jsonl")


# The reference writes hellaswag metadata to spoken_swag_{split}.jsonl too
# (data_prep.py:206 — a copy-paste), silently clobbering a SWAG set sharing
# the out_path; this port uses a distinct filename.
def create_spoken_hellaswag(hf_name: str, out_path: str, num_samples=None,
                            split="validation"):
    """Spoken HellaSwag DPO set via TTS (reference :178-228)."""
    from datasets import load_dataset

    ds = load_dataset(hf_name, split=split)
    ds = ds.filter(lambda x: not any(t in x["ctx"] for t in ["[", "]", "/", "http", "\\"]))
    ds = ds.map(lambda x: {"speaker": random.choice(SPEAKERS), **x})

    def select_pos_neg(sample):
        pos_label = int(sample["label"])
        neg_label = random.choice(list(set(range(4)) - {pos_label}))
        pos = sample["ctx_b"] + " " + sample["endings"][pos_label]
        neg = sample["ctx_b"] + " " + sample["endings"][neg_label]
        base = f"{out_path}/audio/{sample['source_id']}_{sample['ind']}"
        return {"prompt_text": sample["ctx_a"], "chosen_text": pos,
                "rejected_text": neg, "prompt_path": f"{base}_prompt.wav",
                "chosen_path": f"{base}_chosen.wav",
                "rejected_path": f"{base}_rejected.wav"}

    ds = ds.map(select_pos_neg)
    ds = ds.remove_columns(["ind", "activity_label", "ctx_a", "ctx_b", "ctx",
                            "endings", "source_id", "split", "split_type", "label"])
    if num_samples:
        ds = ds.select(range(num_samples))
    _synthesise_split(list(ds), SPEAKERS, out_path, f"spoken_hellaswag_{split}.jsonl")
