"""The port's training surface against the JAX package's at float32 on the CPU:
`UnitLM.loss_fn` and every parameter gradient against `jax.grad(loss_fn)` on
the same weights and the same packed batch, without and with activation
checkpointing (full and partial remat), and the cross-entropy loss itself.

Tolerance: 1e-4 absolute and relative, as the forward's tests: a float32
two-layer forward and backward whose sums run in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.utils.calculation_utils import cross_entropy_loss as jax_cross_entropy
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, grads_to_flat
from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
from slamkit_tpu_torch.utils.calculation_utils import cross_entropy_loss

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)

SMALL_QWEN = dict(
    base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502, twist_init=False,
    torch_dtype="float32", rope_theta=10000,
    config_overrides=dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=16, intermediate_size=128))


def packed_batch(seed, b=2, t=48, vocab=502):
    """Rows of whole sequences with segment ids, per-segment positions, -100
    on each segment's first label and on the -1 tail, as packing builds them."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, t), np.int32)
    labels = np.full((b, t), -100, np.int32)
    seg = np.full((b, t), -1, np.int32)
    pos = np.zeros((b, t), np.int32)
    for r in range(b):
        col = 0
        for s, n in enumerate(rng.integers(5, 20, 3)):
            n = min(int(n), t - col)
            ids[r, col:col + n] = rng.integers(2, vocab, n)
            labels[r, col + 1:col + n] = ids[r, col + 1:col + n]
            seg[r, col:col + n] = s
            pos[r, col:col + n] = np.arange(n)
            col += n
    return {"input_ids": ids, "labels": labels, "segment_ids": seg, "positions": pos,
            "num_items_in_batch": np.int32((labels != -100).sum() + 7)}


@pytest.fixture(scope="module")
def flat_weights():
    """JAX init with the biases and norm scales moved off their init values."""
    model = JaxUnitLM(JaxUnitLMConfig(**SMALL_QWEN), seed=2)
    flat = _flatten(model.params)
    rng = np.random.default_rng(0)
    for k in ("layers/q_b", "layers/k_b", "layers/v_b", "layers/attn_norm_scale",
              "layers/mlp_norm_scale", "final_norm_scale"):
        base = 1.0 if k.endswith("scale") else 0.0
        flat[k] = (base + 0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    return flat


@pytest.mark.parametrize("remat", [dict(), dict(remat=True), dict(remat=True, remat_layers=1)])
def test_loss_and_every_gradient_match_jax(flat_weights, remat):
    cfg = {**SMALL_QWEN, **remat}
    batch = packed_batch(0)
    jax_model = JaxUnitLM(JaxUnitLMConfig(**cfg), params=jax.tree_util.tree_map(
        jnp.asarray, _unflatten(flat_weights)))
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.value_and_grad(jax_model.loss_fn)(jax_model.params, jax_batch)
    want = _flatten(want_grads)

    model = UnitLM(UnitLMConfig(**cfg), params=flat_weights)
    fwd0 = flash_attention_fwd.launches
    loss = model.loss_fn({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    loss.backward()
    assert flash_attention_fwd.launches == fwd0 and flash_attention_bwd.launches == 0
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = grads_to_flat(model.decoder)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL, err_msg=k)
    assert all(p.grad is not None for p in model.parameters())


def test_remat_recomputes_attention(flat_weights, monkeypatch):
    """With remat every checkpointed layer's forward (attention included) runs
    again in the backward, and the gradients equal the plain run's."""
    from slamkit_tpu_torch.models import transformer

    calls = []
    real = transformer.flash_attention
    monkeypatch.setattr(transformer, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in packed_batch(1).items()}
    grads = []
    for remat in (False, True):
        calls.clear()
        model = UnitLM(UnitLMConfig(**{**SMALL_QWEN, "remat": remat}), params=flat_weights)
        model.loss_fn(batch).backward()
        assert len(calls) == (4 if remat else 2)
        grads.append(grads_to_flat(model.decoder))
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k], grads[0][k], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("num_items", [None, 37])
@pytest.mark.parametrize("pre_shifted", [False, True])
def test_cross_entropy_matches_jax(num_items, pre_shifted):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 9)).astype(np.int32)
    labels[:, ::3] = -100
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if num_items is None else jnp.int32(num_items),
                             pre_shifted=pre_shifted)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             num_items, pre_shifted=pre_shifted)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_training_refuses_unported_knobs():
    for knob in (dict(dropout=0.1), dict(layerdrop=0.1), dict(attention_dropout=0.1),
                 dict(remat=True, remat_policy="qkv")):
        with pytest.raises(ValueError, match="ROADMAP"):
            UnitLM(dataclasses.replace(UnitLMConfig(**SMALL_QWEN), **knob))


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
