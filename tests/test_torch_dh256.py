"""SIMS at EleutherAI/pythia-1b's widths (heads of 256) on the port, on the CPU.

  * The plain backward at head dim 256 (what the card's d = 256 kernels are
    held to) against the JAX package's Pallas `_bwd` in interpret mode, in
    float32: G = 1, 2, 4 and 8, T = 1 and T off the 64- and 32-row tiles,
    causal and not, packed rows with a -1 tail, left pads and SIMS's mixed
    segments, and d = 160 and 192, which the card zero-pads to 256 (and the
    JAX wrapper to the next multiple of 128 lanes, 256: the JAX side runs
    on the padded inputs at the original scale). Tolerance 2e-5, as
    tests/test_torch_flash_backward.py's: float32 on both sides, summed in
    another order.
  * pythia-1b's config.json (`sims_recipe.write_pythia1b_base`) read by the
    port's `config_from_hf_dict` equal to the JAX one's: 8 heads of 256,
    rotary on 64 dims of each.
  * One SIMS training step's loss and every gradient on a 2-layer gpt_neox
    decoder of pythia-1b's layout at hidden 512 with 2 heads of 256, the
    port on the CPU against `jax.value_and_grad` of the JAX model on the
    same weights (carried across by `convert.load_flat` / `to_flat`) and
    the same packed rows of text and unit ids. Tolerance 1e-4, as
    tests/test_torch_training.py's: a float32 two-layer forward and
    backward whose sums run in another order.
  * The smoke's phase 19 rehearsed on the CPU at narrow widths: `cli.train
    --config-name train_inter_scale` over the pythia-1b base, the save of
    step 1 alone, the run resumed from it repeating step 2 bit for bit, one
    microbatch against float32 on the CPU at 2 layers, and no kernel launch
    counted.
"""
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.models import presets as jax_presets
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, grads_to_flat, presets, to_flat
from slamkit_tpu_torch.models.convert import load_flat
from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
from slamkit_tpu_torch.ops.flash_attention import kernel_head_dim
from slamkit_tpu_torch.tools import sims_recipe
from test_torch_dh128 import _mixed
from test_torch_flash_backward import TOL, _inputs, _jax_grads, _segments, _torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_TOL = dict(atol=1e-4, rtol=1e-4)

# (b, h, hkv, t, d, causal, segments)
D256_CASES = [
    (2, 4, 4, 65, 256, True, "packed"),         # G = 1, one row past a 64-row tile
    (1, 4, 2, 129, 256, False, "left_padded"),  # G = 2, non-causal
    (1, 8, 2, 100, 256, True, "mixed"),         # G = 4, SIMS's packed rows in small
    (1, 8, 1, 70, 256, False, "packed"),        # G = 8, non-causal, a -1 tail
    (2, 2, 1, 1, 256, True, None),              # T = 1
    (1, 4, 2, 65, 160, True, "packed"),         # d = 160, padded to 256 on the card
    (1, 2, 1, 33, 192, False, "mixed"),         # d = 192, padded
]


@pytest.mark.parametrize("b,h,hkv,t,d,causal,kind", D256_CASES)
def test_d256_backward_matches_pallas(b, h, hkv, t, d, causal, kind):
    assert kernel_head_dim(d) == 256
    q, k, v, do = _inputs(t + d + h + 1, b, h, hkv, t, d)
    seg = _mixed(b, t, seed=t) if kind == "mixed" else _segments(kind, b, t)
    if seg is not None and not causal:
        do = do * (seg >= 0)[:, None, :, None]       # training's zero dO on pads
    pad = lambda x: np.pad(x, [(0, 0)] * 3 + [(0, 256 - d)])
    want = [w[..., :d] for w in _jax_grads(pad(q), pad(k), pad(v), pad(do), seg, seg, causal,
                                           d ** -0.5)]
    tq, tk, tv, tdo, tseg = _torch(q, k, v, do, seg)
    out, lse = flash_attention_fwd(tq, tk, tv, segment_ids=tseg, causal=causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tseg, causal=causal)
    assert flash_attention_bwd.launches == before      # the CPU runs the plain version
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_pythia1b_config_reads_as_the_jax_package_reads_it(tmp_path):
    base = pathlib.Path(sims_recipe.write_pythia1b_base(tmp_path / "pythia1b"))
    hf = json.loads((base / "config.json").read_text())
    assert hf == sims_recipe.PYTHIA1B_CONFIG
    got = presets.DecoderConfig(**presets.config_from_hf_dict(hf))
    want = jax_presets.DecoderConfig(**jax_presets.config_from_hf_dict(hf))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hidden_size, got.num_layers, got.num_heads, got.num_kv_heads, got.head_dim,
            got.intermediate_size, got.vocab_size) == (2048, 16, 8, 8, 256, 8192, 50304)
    assert int(got.head_dim * got.rotary_pct) == 64 and got.parallel_residual
    assert not got.tie_word_embeddings and got.norm == "layernorm" and got.norm_eps == 1e-5
    # the tokenizer is pythia-14m's: the suite shares one
    small = pathlib.Path(sims_recipe.write_pythia14m_base(tmp_path / "pythia14m"))
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        assert (base / name).read_bytes() == (small / name).read_bytes(), name


def _sims_rows(seed, n_text, b=2, t=96):
    """Packed rows as SIMS's mix gives them: segments of text ids, of unit
    ids and of both, per-segment positions, -100 on each segment's first
    label and on the -1 tail."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, t), np.int32)
    labels = np.full((b, t), -100, np.int32)
    seg = np.full((b, t), -1, np.int32)
    pos = np.zeros((b, t), np.int32)
    for r in range(b):
        col = 0
        for s, n in enumerate(rng.integers(10, 40, 3)):
            n = min(int(n), t - 5 - col)
            lo, hi = [(2, n_text), (n_text, n_text + 500), (2, n_text + 500)][s % 3]
            ids[r, col:col + n] = rng.integers(lo, hi, n)
            labels[r, col + 1:col + n] = ids[r, col + 1:col + n]
            seg[r, col:col + n] = s
            pos[r, col:col + n] = np.arange(n)
            col += n
    return {"input_ids": ids, "labels": labels, "segment_ids": seg, "positions": pos,
            "num_items_in_batch": np.int32((labels != -100).sum())}


def test_sims_step_at_heads_of_256_matches_jax(tmp_path):
    base = sims_recipe.write_pythia1b_base(tmp_path / "pythia1b")
    n_text = sims_recipe.NEOX_VOCAB
    cfg = dict(base_model_name=base, vocab_size=n_text + 502, twist_init=False,
               torch_dtype="float32", attn_implementation="flash_attention_2",
               config_overrides=dict(num_hidden_layers=2, hidden_size=512,
                                     num_attention_heads=2, num_key_value_heads=2,
                                     head_dim=256, intermediate_size=2048))
    jax_cfg = {**cfg, "attn_implementation": None}    # its Pallas kernel would run interpreted
    jax_model = JaxUnitLM(JaxUnitLMConfig(**jax_cfg), seed=1)
    flat = _flatten(jax_model.params)
    rng = np.random.default_rng(0)
    for key in flat:      # biases and norm scales off their init values
        if key.endswith("_b") or key.endswith("_scale") or key.endswith("_bias"):
            base_value = 1.0 if key.endswith("_scale") else 0.0
            flat[key] = (base_value + 0.1 * rng.standard_normal(flat[key].shape)
                         ).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, jax_model.params)
    params = _replace_flat(params, flat)
    batch = _sims_rows(3, n_text)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.value_and_grad(jax_model.loss_fn)(params, jax_batch)
    want = _flatten(want_grads)

    model = UnitLM(UnitLMConfig(**cfg), device="cpu", seed=5)
    dcfg = model.decoder.cfg
    assert (dcfg.num_heads, dcfg.head_dim, dcfg.attn_impl) == (2, 256, "flash")
    load_flat(model.decoder, flat)
    assert all(np.array_equal(x, flat[k]) for k, x in to_flat(model.decoder).items())
    launches = flash_attention_fwd.launches, flash_attention_bwd.launches
    loss = model.loss_fn({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    loss.backward()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == launches
    np.testing.assert_allclose(loss.item(), float(want_loss), **STEP_TOL)
    got = grads_to_flat(model.decoder)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), err_msg=key, **STEP_TOL)


def _replace_flat(params, flat):
    """The JAX params pytree with its leaves taken from `flat` (the
    `_flatten` names)."""
    out = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    assert jax.tree_util.tree_structure(out) == jax.tree_util.tree_structure(params)
    return out


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(str(ROOT))
    return mod


def test_chip_smoke_pythia1b_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """Phase 19 end to end on the CPU at 2 layers, 2 heads of 32 and context
    128: both runs take their steps, only checkpoint-1 is written, the
    resumed run repeats step 2 bit for bit, the CPU's "card" side equals its
    float32 side, no launch is counted, and the phase leaves nothing
    behind."""
    narrow = [f"+model.config_args.{k}={v}" for k, v in dict(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=2, num_key_value_heads=2,
        head_dim=32, intermediate_size=128).items()]
    result = chip_smoke.run_pythia1b_training(torch.device("cpu"), "cpu rehearsal", tmp_path,
                                              model_overrides=narrow, n_rows=12,
                                              lengths=(30, 90), context=128, batch=2,
                                              cpu_tokens=64)
    assert result["launches"] == [0, 0] and result["resumed_launches"] == [0, 0]
    assert result["layers"] == 2 and result["head_dim"] == 32 and len(result["losses"]) == 2
    assert result["resumed_loss"] == result["losses"][-1]
    assert result["card_vs_cpu"]["loss_err"] == 0.0
    assert result["card_vs_cpu"]["min_grad_cosine"] == pytest.approx(1.0, abs=1e-6)
    assert len(result["step_seconds"]) == 2 and len(result["resumed_step_seconds"]) == 1
    assert result["checkpoint_bytes"] > 0 and result["cuts"] == list(chip_smoke.PYTHIA1B_CUTS)
    json.dumps(result)
    out = capsys.readouterr().out
    assert "pythia-1b SIMS resumed from checkpoint-1: step 2 loss" in out
    assert "card vs CPU on one packed [1, 64] microbatch" in out
    assert list(tmp_path.iterdir()) == []


def test_bench_flash_backward_breakdown_needs_a_card(monkeypatch, capsys):
    """`tools/bench_flash.py --bwd-kernels` (a backward call's device time by
    CUDA kernel) refuses a host without a card, as its other modes do."""
    from slamkit_tpu_torch.tools import bench_flash

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_flash.main(["--bwd-kernels", "--dim", "256", "--heads", "8", "--hkv", "8"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
