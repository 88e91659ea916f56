"""The port's preset table and DecoderConfig are copies of the JAX package's
(the JAX module cannot be imported without jax): hold them equal."""
import dataclasses

import pytest

from slamkit_tpu.models import presets as jax_presets
from slamkit_tpu_torch.models import presets as torch_presets


def test_preset_table_equal():
    assert torch_presets.PRESETS == jax_presets.PRESETS


def test_decoder_config_fields_equal():
    from slamkit_tpu.models.transformer import DecoderConfig as JaxDecoderConfig

    jax_fields = [(f.name, f.default) for f in dataclasses.fields(JaxDecoderConfig)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(torch_presets.DecoderConfig)]
    assert port_fields == jax_fields


@pytest.mark.parametrize("name", sorted(jax_presets.PRESETS))
def test_resolve_base_config_every_preset(name):
    got = dataclasses.asdict(torch_presets.resolve_base_config(name))
    want = dataclasses.asdict(jax_presets.resolve_base_config(name))
    assert got == want


def test_resolve_slam_overrides():
    """config/model/slam.yaml: Qwen2.5-0.5B with rope_theta 10000, bf16, 502
    units — resolved through UnitLMConfig as the CLIs do."""
    from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxCfg
    from slamkit_tpu_torch.models.unit_lm import UnitLMConfig as PortCfg

    args = dict(base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502,
                rope_theta=10000, torch_dtype="bfloat16", twist_init=False,
                num_attention_heads=7, num_key_value_heads=1, head_dim=128)
    for extra in ({}, {"num_attention_heads", "num_key_value_heads", "head_dim"}):
        kw = {k: v for k, v in args.items() if k not in extra}
        got = dataclasses.asdict(PortCfg.from_dict(kw).decoder_config())
        want = dataclasses.asdict(JaxCfg.from_dict(kw).decoder_config())
        assert got == want
    slam = PortCfg.from_dict({k: args[k] for k in list(args)[:5]}).decoder_config()
    assert (slam.rope_theta, slam.dtype, slam.vocab_size, slam.num_layers) == \
        (10000, "bfloat16", 502, 24)


def test_translate_overrides_equal():
    d = {"num_hidden_layers": 2, "rms_norm_eps": 1e-5, "hidden_size": 64, "bogus": 1}
    assert torch_presets.translate_decoder_overrides(d) == \
        jax_presets.translate_decoder_overrides(d)


def test_unknown_base_model_raises():
    with pytest.raises(ValueError, match="Unknown base model"):
        torch_presets.resolve_base_config("no/such-model")
