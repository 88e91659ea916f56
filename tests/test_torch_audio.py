"""The port's audio I/O against the JAX package's (`slamkit_tpu/utils/audio.py`
over `slamkit_tpu/native/audio.cpp`): both decoders read the same libav, so
FLAC (16-bit and 24-bit, mono and stereo, 16 kHz and 44.1 kHz with
libswresample's resampling and downmix) and WAV (a 22.05 kHz one too) decode
bit for bit alike, and `audio_info` agrees. 16 kHz mono FLAC equals its PCM
/ 2^(bits - 1) exactly, and 16 kHz stereo libswresample's downmix of it.
Where the native decoder cannot be built, a WAV is read in Python, as the
JAX package's reader does, and FLAC raises naming libav. The FLAC files come from `tools/data_recipe.py`, whose CRCs are held
to the standard check values.

Every test that calls both packages' decoders is in this file, so that one
test worker builds the JAX package's library.
"""
import logging

import numpy as np
import pytest

import slamkit_tpu.utils.audio as jax_audio
import slamkit_tpu_torch.utils.audio as audio
from slamkit_tpu_torch.native import _build, bindings
from slamkit_tpu_torch.tools import data_recipe

KINDS = [(16000, 1, 16), (16000, 1, 24), (44100, 2, 16), (44100, 2, 24), (16000, 2, 16),
         (44100, 1, 24)]


@pytest.fixture(scope="module")
def audio_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    return data_recipe.write_audio_set(d, len(KINDS), seconds=(0.3, 0.9), seed=0, kinds=KINDS)


@pytest.mark.parametrize("i", range(len(KINDS)), ids=[f"{r}Hz-{c}ch-{b}bit" for r, c, b in KINDS])
def test_flac_decodes_as_jax(audio_set, i):
    flac, wav, pcm, sr, bits = audio_set[i]
    got = audio.load_audio(str(flac))
    want = jax_audio.load_audio(str(flac))
    assert got.dtype == np.float32 and got.size > 0
    np.testing.assert_array_equal(got, want)
    assert audio.audio_info(str(flac)) == jax_audio.audio_info(str(flac)) == (len(pcm), sr)
    if sr == 16000 and pcm.shape[1] == 1:
        np.testing.assert_array_equal(got, (pcm[:, 0] / float(1 << (bits - 1))).astype(np.float32))
    if sr == 16000:    # same rate: libswresample's stereo downmix is (L + R) / sqrt(2)
        np.testing.assert_allclose(got, pcm.sum(1) / np.sqrt(pcm.shape[1])
                                   / float(1 << (bits - 1)), atol=1e-6)
    else:              # resampled to 16 kHz
        assert abs(len(got) - len(pcm) * 16000 / sr) <= 1
    if bits == 16:                      # the WAV twin decodes to the same samples
        np.testing.assert_array_equal(audio.load_audio(str(wav)), got)
    # and at another target rate
    np.testing.assert_array_equal(audio.load_audio(str(flac), 24000),
                                  jax_audio.load_audio(str(flac), 24000))


def test_wav_at_22050_decodes_as_jax(tmp_path):
    pcm = data_recipe.seeded_pcm(np.random.default_rng(1), 0.7, 22050)
    data_recipe.write_wav(tmp_path / "a.wav", pcm, 22050)
    got = audio.load_audio(str(tmp_path / "a.wav"))
    np.testing.assert_array_equal(got, jax_audio.load_audio(str(tmp_path / "a.wav")))
    assert audio.audio_info(str(tmp_path / "a.wav")) == (len(pcm), 22050)
    assert abs(len(got) - len(pcm) * 16000 / 22050) <= 1


def test_without_the_decoder_wav_is_read_in_python(audio_set, tmp_path, monkeypatch, caplog):
    """No libav (or no g++): WAV goes through the Python reader, the JAX
    package's own `_wav_load` and resampling, logged once; FLAC raises with
    the build's error."""
    def unavailable():
        raise bindings.NativeUnavailable("g++ failed building libaudio.so: no libav")

    monkeypatch.setattr(bindings, "_lib", unavailable)
    monkeypatch.setattr(audio, "_fallback_logged", False)
    data_recipe.write_wav(tmp_path / "s.wav", audio_set[2][2], 44100)
    with caplog.at_level(logging.WARNING, logger=audio.__name__):
        for _ in range(2):
            got = audio.load_audio(str(tmp_path / "s.wav"))
            wav, sr = jax_audio._wav_load(str(tmp_path / "s.wav"))
            np.testing.assert_array_equal(got, jax_audio._resample_poly(wav, sr, 16000))
        flac, twin = audio_set[0][:2]
        np.testing.assert_array_equal(audio.load_audio(str(twin)), jax_audio._wav_load(str(twin))[0])
        assert audio.audio_info(str(twin)) == jax_audio._wav_info(str(twin))
    assert sum("reading WAV in Python" in r.getMessage() for r in caplog.records) == 1
    for fn in (audio.load_audio, audio.audio_info):
        with pytest.raises(IOError, match="libav"):
            fn(str(flac))


def test_decoder_builds_outside_the_package(audio_set):
    lib = _build.library_path("audio")
    assert bindings.available() and lib.is_file()
    assert lib.parent.parent == _build.BUILD_ROOT and _build.HERE not in lib.parents
    assert not list(_build.HERE.glob("*.so"))
    with pytest.raises(IOError, match="native decode failed"):
        bindings.decode_audio(str(audio_set[0][0]) + ".missing")


def test_flac_crcs_are_the_standard_ones():
    # CRC-8 (poly 0x07) and CRC-16 (poly 0x8005, the FLAC / UMTS one) of
    # "123456789"; leading zero bytes leave a zero-start CRC unchanged
    assert data_recipe.crc8(b"123456789") == 0xF4
    assert data_recipe.crc16_many([b"123456789", b"\x00\x00123456789", b""]) == [0xFEE8,
                                                                                  0xFEE8, 0]
    assert [data_recipe._utf8_number(n).hex() for n in (0, 127, 128, 2047, 2048, 65536)] == \
        ["00", "7f", "c280", "dfbf", "e0a080", "f0908080"]
