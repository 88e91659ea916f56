"""The unit tokeniser's library surface on the port against the JAX
package's (`slamkit_tpu/tokeniser/unit_tokeniser.py:44-57`, `:134`,
`:156-172`): `UnitVocab.convert_ids_to_tokens` and `decode`,
`UnitTokeniser.prepare_sample`, and `save_pretrained` / `from_pretrained`
through `tokeniser_config.json`, whose bytes are the JAX file's and which
each package loads from the other's, at the default layout and at one with
other special ids.
"""
import numpy as np
import pytest

from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu_torch.tokeniser import UnitTokeniser

LAYOUTS = [dict(), dict(dedup=False, bos_eos_token_id=3, pad_token_id=2, num_units=100)]
ATTRS = ("dedup", "bos_token_id", "eos_token_id", "pad_token_id", "num_units", "offset")


def _pair(layout):
    return UnitTokeniser(**layout), JaxUnitTokeniser(load_fe=False, **layout)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_convert_ids_to_tokens_and_decode_equal_jax(layout):
    port, ref = _pair(layout)
    n = len(ref.text_tokeniser)
    cases = [0, 1, 2, 3, n - 1, [0, 1, 5, 7, 1, 0], np.arange(n), np.int32(9), []]
    for ids in cases:
        got = port.text_tokeniser.convert_ids_to_tokens(ids)
        assert got == ref.text_tokeniser.convert_ids_to_tokens(ids), ids
        assert port.text_tokeniser.decode(ids) == ref.text_tokeniser.decode(ids), ids
    assert port.text_tokeniser.convert_ids_to_tokens([0, port.offset, 1])[1] == "<Un0>"
    for vocab in (port.text_tokeniser, ref.text_tokeniser):   # one sequence at a time
        with pytest.raises(TypeError):
            vocab.decode(np.array([[4, 5], [6, 0]]))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kwargs", [dict(), dict(padding=True), dict(add_special_tokens=False),
                                    dict(add_special_tokens=False, padding=True)])
def test_prepare_sample_equals_jax(layout, kwargs):
    port, ref = _pair(layout)
    for units in ([5, 5, 17, 0, 42], [], list(range(60))):
        sample = {"audio_repr": "".join(f"<Un{u}>" for u in units), "file_name": "x"}
        got, want = port.prepare_sample(sample, **kwargs), ref.prepare_sample(sample, **kwargs)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_save_pretrained_is_the_jax_file_and_loads_both_ways(tmp_path, layout):
    port, ref = _pair(layout)
    port.save_pretrained(str(tmp_path / "port"))
    ref.save_pretrained(str(tmp_path / "jax"))
    name = "tokeniser_config.json"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for loaded, want in ((UnitTokeniser.from_pretrained(str(tmp_path / "jax")), port),
                         (JaxUnitTokeniser.from_pretrained(str(tmp_path / "port")), ref),
                         (UnitTokeniser.from_pretrained(str(tmp_path / "port")), port)):
        assert [getattr(loaded, a) for a in ATTRS] == [getattr(want, a) for a in ATTRS]
        assert loaded.model is None and len(loaded.text_tokeniser) == len(want.text_tokeniser)
    # the loaded tokeniser encodes as the saved one does; the saved directory
    # round-trips to the same bytes
    again = UnitTokeniser.from_pretrained(str(tmp_path / "jax"))
    assert again("<Un3><Un4>") == port("<Un3><Un4>")
    again.save_pretrained(str(tmp_path / "again"))
    assert (tmp_path / "again" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_from_pretrained_refuses_what_the_file_holds(tmp_path):
    """A constructor argument the file already holds (or the feature
    extractor, which from_pretrained sets to None) raises in both packages."""
    UnitTokeniser().save_pretrained(str(tmp_path))
    for cls in (UnitTokeniser, JaxUnitTokeniser):
        for kwargs in (dict(num_units=10), dict(speech_tokeniser=None)):
            with pytest.raises(TypeError, match="multiple values"):
                cls.from_pretrained(str(tmp_path), **kwargs)
