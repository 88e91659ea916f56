"""model=slam_dh128 (config/model/slam_dh128.yaml) on the port, on the CPU.

  * The plain backward at head dim 128 (what the card's d = 128 kernel is
    held to) against the JAX package's Pallas `_bwd` in interpret mode, in
    float32, at group sizes and layouts the d = 128 kernel takes beyond
    tests/test_torch_flash_backward.py's 7 / 1: G = 8 (Qwen2.5-3B's 16 / 2
    heads, chip_smoke's `qwen25_3b_sims`), G = 3 and 4, T = 1 and T off the
    tile sizes, a -1 tail, left pads, non-causal, and d = 96 and 112, which
    the card zero-pads to 128. Tolerance 2e-5, as that file's: float32 on
    both sides, summed in another order.
  * The composed config: the Slam recipe's decoder re-headed to 7 heads of
    128 with one kv head, 24 layers, the same parameter count as model=slam.
  * The smoke's phase 18 rehearsed on the CPU at narrow widths: `cli.train
    model=slam_dh128`, a save a step, the run resumed from checkpoint-1
    repeating step 2 bit for bit, one microbatch against float32 on the CPU,
    and no kernel launch counted.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from slamkit_tpu_torch.config import compose
from slamkit_tpu_torch.models import UnitLMConfig
from slamkit_tpu_torch.models.unit_lm import _plain
from slamkit_tpu_torch.ops import flash_attention_bwd, flash_attention_fwd
from test_torch_flash_backward import TOL, _inputs, _jax_grads, _segments, _torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _mixed(b, t, seed):
    """[b, t] ids of segments of mixed length (some shorter than a 64-row
    tile, some longer), then a -1 tail: SIMS's packed rows in small."""
    rng = np.random.default_rng(seed)
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        col, s = 0, 0
        while True:
            n = int(rng.integers(5, 40) if rng.random() < 0.5 else rng.integers(60, 120))
            if col + n > t - 3:
                break
            seg[r, col:col + n] = s
            col, s = col + n, s + 1
    return seg


# (b, h, hkv, t, d, causal, segments)
D128_CASES = [
    (1, 16, 2, 150, 128, True, "mixed"),        # G = 8, Qwen2.5-3B's heads
    (2, 8, 2, 129, 128, True, "packed"),        # G = 4, one row past a tile
    (1, 6, 2, 70, 128, False, "left_padded"),   # G = 3, non-causal
    (2, 7, 1, 1, 128, True, None),              # T = 1
    (1, 8, 2, 65, 96, True, "packed"),          # d = 96, padded to 128 on the card
    (1, 7, 1, 100, 112, False, "mixed"),        # d = 112, padded
]


@pytest.mark.parametrize("b,h,hkv,t,d,causal,kind", D128_CASES)
def test_d128_backward_matches_pallas(b, h, hkv, t, d, causal, kind):
    q, k, v, do = _inputs(t + d + h + 1, b, h, hkv, t, d)
    seg = _mixed(b, t, seed=t) if kind == "mixed" else _segments(kind, b, t)
    if seg is not None and not causal:
        do = do * (seg >= 0)[:, None, :, None]       # training's zero dO on pads
    want = _jax_grads(q, k, v, do, seg, seg, causal, d ** -0.5)
    tq, tk, tv, tdo, tseg = _torch(q, k, v, do, seg)
    out, lse = flash_attention_fwd(tq, tk, tv, segment_ids=tseg, causal=causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tseg, causal=causal)
    assert flash_attention_bwd.launches == before      # the CPU runs the plain version
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_slam_dh128_composes_to_the_reheaded_slam_decoder():
    """7 heads of 128 and one kv head over Slam's 896 hidden and 24 layers:
    the q width (7 x 128 = 14 x 64) and the kv width (1 x 128 = 2 x 64) of
    model=slam, so the same parameters; every other field of the decoder is
    model=slam's."""
    dcfg = {}
    for model in ("slam", "slam_dh128"):
        cfg = compose(str(ROOT / "config"), "train", [f"model={model}"])
        dcfg[model] = dataclasses.asdict(
            UnitLMConfig.from_dict(_plain(cfg.model.config_args)).decoder_config())
    heads = ("num_heads", "num_kv_heads", "head_dim")
    assert tuple(dcfg["slam_dh128"][k] for k in heads) == (7, 1, 128)
    assert tuple(dcfg["slam"][k] for k in heads) == (14, 2, 64)
    assert (dcfg["slam_dh128"]["num_layers"], dcfg["slam_dh128"]["hidden_size"]) == (24, 896)
    width = lambda c: (c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"])
    assert width(dcfg["slam_dh128"]) == width(dcfg["slam"]) == (896, 128)
    rest = lambda c: {k: v for k, v in c.items() if k not in heads}
    assert rest(dcfg["slam_dh128"]) == rest(dcfg["slam"])


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(str(ROOT))
    return mod


def test_chip_smoke_dh128_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """Phase 18 end to end on the CPU at 2 layers, 4 heads of 32 over one kv
    head and context 64: both runs take their steps, the resumed run repeats
    step 2 bit for bit, the CPU's "card" side equals its float32 side, no
    launch is counted, and the phase leaves only its corpus behind."""
    narrow = ["model.config_args.torch_dtype=float32"] + [
        f"+model.config_args.{k}={v}" for k, v in dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=1,
            head_dim=32, intermediate_size=128).items()]
    result = chip_smoke.run_dh128_training(torch.device("cpu"), "cpu rehearsal", tmp_path,
                                           model_overrides=narrow, n_rows=24, lengths=(10, 60),
                                           context=64, batch=2, accum=2, cpu_batch=2,
                                           cpu_context=64)
    assert result["launches"] == [0, 0] and result["resumed_launches"] == [0, 0]
    assert result["layers"] == 2 and len(result["losses"]) == 2
    assert result["resumed_loss"] == result["losses"][-1]
    assert result["card_vs_cpu"]["loss_err"] == 0.0
    assert result["card_vs_cpu"]["min_grad_cosine"] == pytest.approx(1.0, abs=1e-6)
    assert len(result["step_seconds"]) == 2 and len(result["resumed_step_seconds"]) == 1
    json.dumps(result)
    out = capsys.readouterr().out
    assert "slam_dh128 resumed from checkpoint-1: step 2 loss" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dh128_tokens.jsonl"]
