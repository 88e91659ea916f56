"""The port's Decoder against the JAX package's `forward`, in float32 on the
CPU, on the same weights: every family of the preset table, a packed batch
with segment ids and per-segment positions, the prefill + cached decode path,
and the params.npz conversion.

Tolerance: 1e-4 absolute and relative on logits — two layers of float32
matmuls and norms whose sums run in a different order in XLA and PyTorch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.models import init_cache as jax_init_cache
from slamkit_tpu.models import init_params as jax_init_params
from slamkit_tpu.models.presets import resolve_base_config as jax_resolve
from slamkit_tpu.models.transformer import forward as jax_forward
from slamkit_tpu.models.unit_lm import _flatten, _unflatten
from slamkit_tpu_torch.models import Decoder, init_cache, load_flat, to_flat
from slamkit_tpu_torch.models.presets import DecoderConfig, resolve_base_config

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             intermediate_size=128, vocab_size=96, max_position_embeddings=128,
             dtype="float32")

FAMILIES = {
    "qwen2": ("Qwen/Qwen2.5-0.5B", dict(rope_theta=10000.0)),
    "llama": ("meta-llama/Llama-3.2-1B", dict(num_kv_heads=1)),
    "llama_gelu_glu": ("meta-llama/Llama-3.2-1B", dict(act="gelu_glu",
                                                       tie_word_embeddings=False)),
    "opt": ("facebook/opt-125m", dict(num_kv_heads=4)),
    # opt-350m: post-LN blocks, no final norm, project_in/out around the stack
    "opt350m": ("facebook/opt-125m", dict(num_kv_heads=4, pre_norm=False,
                                          embed_proj_dim=32)),
    "gpt_neox": ("EleutherAI/pythia-14m", dict(num_kv_heads=4)),
}


def _configs(family):
    name, extra = FAMILIES[family]
    kw = {**SMALL, **extra}
    return resolve_base_config(name, **kw), jax_resolve(name, **kw)


def _random_flat(jcfg, seed):
    """Every array of the JAX params tree, drawn at random (biases and norm
    scales too, so no branch hides behind zeros and ones)."""
    shapes = {k: v.shape for k, v in _flatten(jax_init_params(jcfg, jax.random.PRNGKey(0))).items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for k, shape in sorted(shapes.items()):
        x = rng.standard_normal(shape).astype(np.float32)
        flat[k] = (1.0 + 0.1 * x) if k.endswith("_scale") else 0.05 * x
    return flat


def _port_decoder(cfg, flat):
    return load_flat(Decoder(cfg), flat)


def _packed_batch(vocab, seed):
    """Two rows of 40: packed segments with per-segment positions and a -1
    pad tail, as the trainer's packing collator builds them."""
    rng = np.random.default_rng(seed)
    seg = np.array([[0] * 15 + [1] * 20 + [-1] * 5,
                    [0] * 30 + [1] * 10]).astype(np.int32)
    pos = np.zeros_like(seg)
    for r in range(2):
        for s in np.unique(seg[r]):
            idx = np.where(seg[r] == s)[0]
            pos[r, idx] = 0 if s < 0 else np.arange(len(idx))
    ids = rng.integers(2, vocab, seg.shape).astype(np.int32)
    ids[seg < 0] = 0
    return ids, pos, seg


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_logits_match_jax(family):
    cfg, jcfg = _configs(family)
    flat = _random_flat(jcfg, seed=1)
    ids, pos, seg = _packed_batch(cfg.vocab_size, seed=2)
    want, _ = jax_forward(_unflatten(flat), jcfg, jnp.asarray(ids),
                          positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        got, _ = _port_decoder(cfg, flat)(torch.from_numpy(ids),
                                          positions=torch.from_numpy(pos),
                                          segment_ids=torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("family", ["qwen2", "opt350m", "gpt_neox"])
def test_prefill_and_cached_decode_match_jax(family):
    """Left-padded prompts: prefill at cache index 0, then single-token steps;
    each step matches JAX's cached forward and the port's own full forward."""
    cfg, jcfg = _configs(family)
    flat = _random_flat(jcfg, seed=3)
    dec = _port_decoder(cfg, flat)
    params = _unflatten(flat)
    b, l0, total = 2, 8, 12
    rng = np.random.default_rng(4)
    ids = rng.integers(2, cfg.vocab_size, (b, total)).astype(np.int32)
    mask = np.ones((b, total), np.int32)
    mask[1, :3] = 0                                   # row 1 is left-padded
    ids[mask == 0] = 0
    seg = np.where(mask > 0, 0, -1).astype(np.int32)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    t = torch.from_numpy

    with torch.no_grad():
        full, _ = dec(t(ids), positions=t(pos), segment_ids=t(seg))
        cache = init_cache(cfg, b, total)
        pre, cache = dec(t(ids[:, :l0]), positions=t(pos[:, :l0]),
                         segment_ids=t(seg[:, :l0]), cache=cache, cache_index=0)
    jcache = jax_init_cache(jcfg, b, total, dtype=jnp.float32)
    jpre, jcache = jax_forward(params, jcfg, jnp.asarray(ids[:, :l0]),
                               positions=jnp.asarray(pos[:, :l0]),
                               segment_ids=jnp.asarray(seg[:, :l0]),
                               cache=jcache, cache_index=0)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(pre.numpy(), full[:, :l0].numpy(), **TOL)
    for i in range(l0, total):
        with torch.no_grad():
            step, cache = dec(t(ids[:, i:i + 1]), positions=t(pos[:, i:i + 1]),
                              segment_ids=t(seg), cache=cache, cache_index=i)
        jstep, jcache = jax_forward(params, jcfg, jnp.asarray(ids[:, i:i + 1]),
                                    positions=jnp.asarray(pos[:, i:i + 1]),
                                    segment_ids=jnp.asarray(seg),
                                    cache=jcache, cache_index=i)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(), **TOL,
                                   err_msg=f"step {i}")
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(jcache[0]), **TOL)


@pytest.mark.parametrize("family", ["qwen2", "opt350m", "gpt_neox"])
def test_params_npz_round_trip(family):
    """JAX init -> flat params.npz dict -> port -> flat dict: equal bit for
    bit, same keys."""
    _, jcfg = _configs(family)
    cfg = _configs(family)[0]
    flat = _flatten(jax_init_params(jcfg, jax.random.PRNGKey(5)))
    back = to_flat(_port_decoder(cfg, flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_load_flat_rejects_mismatched_params():
    cfg, jcfg = _configs("qwen2")
    flat = _random_flat(jcfg, seed=6)
    with pytest.raises(ValueError, match="missing"):
        load_flat(Decoder(cfg), {k: v for k, v in flat.items() if k != "layers/q_b"})
    flat["layers/q_w"] = flat["layers/q_w"][:, :, :8]
    with pytest.raises(ValueError, match="shape"):
        load_flat(Decoder(cfg), flat)


def test_learned_pos_overflow_raises():
    cfg, _ = _configs("opt")
    dec = Decoder(cfg).reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        dec(torch.zeros((1, cfg.max_position_embeddings + 1), dtype=torch.long))


@pytest.mark.parametrize("knob", [dict(dropout=0.1), dict(attention_dropout=0.1),
                                  dict(layerdrop=0.1), dict(remat=True, remat_policy="qkv")])
def test_training_knobs_raise(knob):
    cfg = dataclasses.replace(_configs("qwen2")[0], **knob)
    with pytest.raises(ValueError):
        Decoder(cfg)


def test_reset_parameters_is_seeded():
    cfg = DecoderConfig(**{**SMALL, "qkv_bias": True})
    a = to_flat(Decoder(cfg).reset_parameters(torch.Generator().manual_seed(0)))
    b = to_flat(Decoder(cfg).reset_parameters(torch.Generator().manual_seed(0)))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert np.all(a["layers/attn_norm_scale"] == 1.0) and np.all(a["layers/q_b"] == 0.0)
    assert abs(float(a["layers/q_w"].std()) - cfg.initializer_range) < 0.005
