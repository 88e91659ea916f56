"""Seeded audio and token corpora for the data path's tests and `chip_smoke.py`.

    write_flac_files([(path, pcm, sample_rate, bits), ...])   # pcm: int [n] or [n, channels]
    write_wav(path, pcm, sample_rate, bits)
    write_audio_set(folder, n, seconds, seed)      # FLAC and WAV twins of the same PCM
    write_unit_corpus(path, n_tokens, seed)        # a tokens.jsonl of <UnN> strings

The FLAC writer is plain Python and numpy: a STREAMINFO block, then frames
of 4096 samples (the last one shorter) whose subframes are VERBATIM, each
frame header closed by its CRC-8 (x^8 + x^2 + x + 1) and each frame by its
CRC-16 (x^16 + x^15 + x^2 + 1), both with a zero start as the format asks.
It takes 16-bit and 24-bit samples, any rate, one or two channels (stored
independently). It exists to fabricate inputs: nothing in the package
encodes FLAC.
"""
from __future__ import annotations

import json
import pathlib
import struct
import wave
from typing import List, Sequence

import numpy as np

BLOCK = 4096
# frame-header codes of the FLAC format: sample rates (others: 0, "see
# STREAMINFO") and sample sizes
_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6, 24000: 7,
               32000: 8, 44100: 9, 48000: 10, 96000: 11}
_SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def _crc_table(poly: int, width: int) -> np.ndarray:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else crc << 1
        table.append(crc & mask)
    return np.asarray(table, dtype=np.uint32)


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8[crc ^ b])
    return crc


def crc16_many(messages: Sequence[bytes]) -> List[int]:
    """The CRC-16 of each message, all at once: the messages are left-padded
    with zero bytes to one length (leading zeros leave a zero-start CRC
    unchanged) and the table step runs down the columns."""
    if not messages:
        return []
    width = max(len(m) for m in messages)
    cols = np.zeros((width, len(messages)), dtype=np.uint32)
    for j, m in enumerate(messages):
        cols[width - len(m):, j] = np.frombuffer(m, dtype=np.uint8)
    crc = np.zeros(len(messages), dtype=np.uint32)
    for row in cols:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[(crc >> 8) ^ row]
    return crc.tolist()


def _utf8_number(n: int) -> bytes:
    """The frame number as FLAC codes it: UTF-8's scheme extended to 36 bits."""
    if n < 0x80:
        return bytes([n])
    n_bytes = 2
    while n >= 1 << (5 * n_bytes + 1):
        n_bytes += 1
    out = [0x80 | ((n >> (6 * k)) & 0x3F) for k in range(n_bytes - 1)][::-1]
    lead = ((0xFF << (8 - n_bytes)) & 0xFF) | (n >> (6 * (n_bytes - 1)))
    return bytes([lead, *out])


def _samples_be(pcm: np.ndarray, bits: int) -> bytes:
    """Signed samples as big-endian bytes of bits / 8 each."""
    if bits == 16:
        return pcm.astype(">i2").tobytes()
    return pcm.astype(">i4").view(np.uint8).reshape(-1, 4)[:, 4 - bits // 8:].tobytes()


def _pcm2d(pcm: np.ndarray, bits: int) -> np.ndarray:
    pcm = np.asarray(pcm)
    pcm = pcm[:, None] if pcm.ndim == 1 else pcm
    if bits not in (16, 24) or pcm.shape[1] not in (1, 2):
        raise ValueError(f"16- or 24-bit, one or two channels; got {bits} bits, "
                         f"{pcm.shape[1]} channels")
    lim = 1 << (bits - 1)
    if pcm.size and (pcm.min() < -lim or pcm.max() >= lim):
        raise ValueError(f"samples outside {bits}-bit range")
    return pcm.astype(np.int32)


def _flac_parts(pcm: np.ndarray, sample_rate: int, bits: int):
    """(stream head, frames without their CRC-16) of one file."""
    pcm = _pcm2d(pcm, bits)
    n, ch = pcm.shape
    info = struct.pack(">HH", BLOCK, BLOCK) + b"\0" * 6    # min / max frame size unknown
    packed = (sample_rate << 44) | ((ch - 1) << 41) | ((bits - 1) << 36) | n
    info += packed.to_bytes(8, "big") + b"\0" * 16          # no MD5
    head = b"fLaC" + bytes([0x80, 0, 0, len(info)]) + info  # last block, STREAMINFO
    frames = []
    for k, lo in enumerate(range(0, n, BLOCK)):
        block = pcm[lo:lo + BLOCK]
        hdr = bytes([0xFF, 0xF8, (0x7 << 4) | _RATE_CODES.get(sample_rate, 0),
                     ((ch - 1) << 4) | (_SIZE_CODES[bits] << 1)])
        hdr += _utf8_number(k) + struct.pack(">H", len(block) - 1)
        hdr += bytes([crc8(hdr)])
        body = b"".join(b"\x02" + _samples_be(block[:, c], bits) for c in range(ch))
        frames.append(hdr + body)
    return head, frames


def write_flac_files(items: Sequence[tuple]) -> None:
    """Write (path, pcm, sample_rate, bits) items, their frames' CRC-16s
    computed in one pass over all of them."""
    parts = [_flac_parts(pcm, sr, bits) for _, pcm, sr, bits in items]
    crcs = iter(crc16_many([f for _, frames in parts for f in frames]))
    for (path, *_), (head, frames) in zip(items, parts):
        with open(path, "wb") as f:
            f.write(head)
            for frame in frames:
                f.write(frame + struct.pack(">H", next(crcs)))


def write_wav(path, pcm: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Signed PCM [n] or [n, channels] as a WAV of `bits` (16 or 24)."""
    pcm = _pcm2d(pcm, bits)
    raw = pcm.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :bits // 8].tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(bits // 8)
        w.setframerate(sample_rate)
        w.writeframes(raw)


def seeded_pcm(rng, seconds: float, sample_rate: int, channels: int = 1,
               bits: int = 16) -> np.ndarray:
    """Signed PCM [n, channels]: a gliding tone in noise per channel, at
    about a third of full scale."""
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    out = []
    for _ in range(channels):
        f0 = rng.uniform(100, 300) * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
        wav = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / sample_rate)
        out.append(np.clip(wav + 0.05 * rng.standard_normal(t.size), -1, 1))
    scale = (1 << (bits - 1)) - 1
    return np.round(np.stack(out, 1) * scale).astype(np.int32)


def write_audio_set(folder, n: int, seconds=(2.0, 16.0), seed: int = 0,
                    kinds=((16000, 1, 16), (44100, 2, 16))) -> list:
    """n seeded files in `folder`, cycling through `kinds` of (rate,
    channels, bits): `<i>.flac`, and a `<i>.wav` of the same PCM in
    `folder/wav/`. Returns [(flac path, wav path, pcm, rate, bits)]."""
    folder = pathlib.Path(folder)
    (folder / "wav").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sr, ch, bits = kinds[i % len(kinds)]
        pcm = seeded_pcm(rng, rng.uniform(*seconds), sr, ch, bits)
        wav = folder / "wav" / f"{i}.wav"
        write_wav(wav, pcm, sr, bits)
        out.append((folder / f"{i}.flac", wav, pcm, sr, bits))
    write_flac_files([(f, pcm, sr, bits) for f, _, pcm, sr, bits in out])
    return out


def write_unit_corpus(path, n_tokens: int, seed: int = 0, lengths=(100, 1001),
                      n_units: int = 500) -> int:
    """A tokens.jsonl of `<UnN>` strings holding at least n_tokens units, rows
    of `lengths` units from a first-order Markov chain in which every unit
    has 4 successors (as `slam_recipe.write_markov_corpus`). Returns the
    unit count."""
    from ..tokeniser.unit_codec import units_to_string

    rng = np.random.default_rng(seed)
    nxt = np.stack([rng.choice(n_units, 4, replace=False) for _ in range(n_units)])
    lens = rng.integers(*lengths, n_tokens // ((lengths[0] + lengths[1]) // 2) + 1)
    while lens.sum() < n_tokens:
        lens = np.concatenate([lens, rng.integers(*lengths, 64)])
    lens = lens[:int(np.searchsorted(np.cumsum(lens), n_tokens)) + 1]
    units = np.empty((len(lens), int(lens.max())), np.int32)
    units[:, 0] = rng.integers(0, n_units, len(lens))
    picks = rng.integers(0, 4, units.shape)
    for i in range(1, units.shape[1]):
        units[:, i] = nxt[units[:, i - 1], picks[:, i]]
    with open(path, "w") as f:
        for r, n in enumerate(lens):
            f.write(json.dumps({"file_name": f"u{r}",
                                "audio_repr": units_to_string(units[r, :n])}) + "\n")
    return int(lens.sum())
