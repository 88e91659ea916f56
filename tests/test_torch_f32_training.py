"""Float32 training on the port, against the JAX package on the CPU.

  * The plain float32 backward (`flash_attention_bwd` on CPU tensors, which
    the float32 CUDA kernel is held to on the card) against the Pallas
    `_bwd` in interpret mode on float32 inputs, at the layouts float32
    training gives it at small size: G = 1 (OPT, train.yaml's default
    model=twist), 7 (Slam) and 8; d = 64 and 128; packed rows with a -1
    tail, DPO's rows of one segment and a -1 tail, a ragged T and dead rows.
    Tolerance 2e-5 absolute and relative: both sides are float32 and differ
    only in summation order.
  * No module of the port changes PyTorch's float32 precision settings
    (TF32 for matmuls and cuDNN, the matmul precision): float32 training is
    only float32 while they hold.
  * `cli.train` with train.yaml's defaults (model=twist: OPT-125m's widths
    cut to 2 layers) in float32 against the JAX `cli/train.py`: losses,
    eval losses 1e-4 relative, learning rates 1e-6 (as
    tests/test_torch_cli.py); the export loads in JAX with the same weights
    and scores as the port does, 1e-4 absolute.
  * The smoke's phase 13 rehearsed on the CPU at narrow widths: float32
    `cli.train` on model=twist and model=slam and float32 DPO, each resumed
    bit for bit, with no kernel launch counted.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu_torch.cli import train as port_train
from slamkit_tpu_torch.models import UnitLM
from slamkit_tpu_torch.ops import flash_attention, flash_attention_bwd, flash_attention_fwd
from test_torch_cli import _history, _jax_cli, _pick, _write_tokens
from test_torch_flash_backward import _jax_grads, _packed, _torch

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-5, rtol=2e-5)


def _dpo_rows(b, t, rng):
    """DPO's collate: one segment of 110..t tokens a row, then a -1 tail."""
    seg = np.full((b, t), -1, np.int32)
    for r in range(b):
        seg[r, :int(rng.integers(min(110, t), t + 1))] = 0
    return seg


# (b, h, hkv, t, d, segments): the twist rows (OPT's 12/12 heads cut to
# 4/4: G = 1), the Slam rows (14/2: G = 7, ragged T), slam_dh128 (7/1),
# G = 8, and DPO's [2 x 1, 152] rows
F32_CASES = [
    (2, 4, 4, 256, 64, "packed"),
    (1, 14, 2, 200, 64, "packed"),
    (2, 7, 1, 192, 128, "packed"),
    (1, 8, 1, 130, 64, "packed"),
    (2, 14, 2, 152, 64, "dpo"),
]


@pytest.mark.parametrize("b,h,hkv,t,d,kind", F32_CASES)
def test_f32_backward_matches_pallas(b, h, hkv, t, d, kind):
    rng = np.random.default_rng(t + h + d)
    mk = lambda hh: (rng.standard_normal((b, hh, t, d)) * 0.5).astype(np.float32)
    q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h) * 2
    third = t // 3
    seg = (_packed(b, [third, t - 2 * third - 9, third, 9]) if kind == "packed"
           else _dpo_rows(b, t, rng))
    want = _jax_grads(q, k, v, do, seg, seg, True, d ** -0.5)
    tq, tk, tv, tdo, tseg = _torch(q, k, v, do, seg)
    out, lse = flash_attention_fwd(tq, tk, tv, segment_ids=tseg)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tseg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
    # the autograd path a float32 training step takes
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    flash_attention(*leaves, segment_ids=tseg).backward(tdo)
    for name, x, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("hkv", [4, 1])
def test_f32_backward_dead_rows_match_pallas(hkv):
    """Query ids absent from the key ids (LSE +1e30) get dq exactly 0 and add
    nothing to dk and dv, at G = 1 and G = 4."""
    b, h, t, d = 1, 4, 128, 64
    rng = np.random.default_rng(5)
    mk = lambda hh: rng.standard_normal((b, hh, t, d)).astype(np.float32)
    q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h)
    q_seg = np.repeat([0, 3, 1, -1], [40, 20, 60, 8])[None].astype(np.int32)
    k_seg = np.repeat([0, 1, -1], [64, 56, 8])[None].astype(np.int32)
    want = _jax_grads(q, k, v, do, q_seg, k_seg, True, d ** -0.5)
    tq, tk, tv, tdo, tqs, tks = _torch(q, k, v, do, q_seg, k_seg)
    out, lse = flash_attention_fwd(tq, tk, tv, segment_ids=tqs, kv_segment_ids=tks)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, segment_ids=tqs, kv_segment_ids=tks)
    dead = q_seg[0] == 3
    assert np.all(got[0].numpy()[:, :, dead] == 0.0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)


_PRECISION = r"""
import importlib, json, pkgutil, sys
import torch

def settings():
    return [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()]

before = settings()
import slamkit_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(slamkit_tpu_torch.__path__,
                                                     "slamkit_tpu_torch."))
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ".")
import chip_smoke  # noqa: F401  (the smoke's own settings are made in main())
after_import = settings()

from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.trainer import SLAMTrainer
from slamkit_tpu_torch.data import TokenDataset

torch.set_num_threads(1)
lm = UnitLM(UnitLMConfig(base_model_name="facebook/opt-125m", vocab_size=502, twist_init=False,
                         torch_dtype="float32", remat=True,
                         config_overrides=dict(num_hidden_layers=1, hidden_size=64,
                                               num_attention_heads=4, num_key_value_heads=4,
                                               head_dim=16, intermediate_size=128)),
            device="cpu")
rows = TokenDataset.from_lists([[1, 5, 6, 7, 8, 9, 1], [1, 9, 8, 7, 1]])
args = {"output_dir": sys.argv[1], "per_device_train_batch_size": 2, "max_steps": 1,
        "learning_rate": 1e-3, "logging_steps": 1, "save_steps": 0, "async_save": False}
state = SLAMTrainer(lm, args, rows, context_len=16).train()
print(json.dumps({"before": before, "after_import": after_import, "after_step": settings(),
                  "modules": len(names), "steps": state.global_step}))
"""


def test_no_module_changes_float32_precision(tmp_path):
    """Every module of the port imported (and chip_smoke.py), then a float32
    training step taken, in a fresh process: allow_tf32 for matmuls and for
    cuDNN and the float32 matmul precision are what they were before."""
    proc = subprocess.run([sys.executable, "-c", _PRECISION, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["steps"] == 1 and got["modules"] > 50, got
    assert got["before"] == [False, True, "highest"], got
    assert got["after_import"] == got["before"] and got["after_step"] == got["before"], got


# train.yaml's default model (model=twist: facebook/opt-125m's widths, the
# OPT family: learned positions with offset 2, LayerNorm with bias, ReLU,
# biased projections, 12 heads of 64) cut to 2 layers
TWIST_LM = dict(base_model_name="facebook/opt-125m", vocab_size=502, twist_init=False,
                torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))


@pytest.fixture(scope="module")
def twist_work(tmp_path_factory):
    """A JAX-written OPT checkpoint, a seeded corpus and validation set."""
    d = tmp_path_factory.mktemp("twist")
    JaxUnitLM(JaxUnitLMConfig(**TWIST_LM), seed=0).save_pretrained(str(d / "ckpt"))
    _write_tokens(d / "train.jsonl", 96, seed=2)
    _write_tokens(d / "val.jsonl", 12, seed=3)
    return d


def _twist_overrides(work, out, per_device, **extra):
    """train.yaml's defaults (no model= override: model=twist, no remat)."""
    ov = {"model.pretrained_model": work / "ckpt", "model.context_len": 64,
          "model.config_args.torch_dtype": "float32",
          "data.train_path": work / "train.jsonl", "data.val_path": work / "val.jsonl",
          "data.packing": "true", "training_args.output_dir": out,
          "training_args.max_steps": 3, "training_args.gradient_accumulation_steps": 2,
          "training_args.per_device_train_batch_size": per_device,
          "training_args.per_device_eval_batch_size": per_device,
          "training_args.logging_steps": 1, "training_args.save_steps": 1,
          "training_args.eval_steps": 3, "training_args.warmup_steps": 1, **extra}
    return [f"{k}={v}" for k, v in ov.items()]


def test_twist_train_cli_in_float32_matches_jax(twist_work):
    """The first parity test of the OPT family's training: both CLIs
    fine-tune one OPT checkpoint in float32 for 3 steps; the JAX CLI on the
    suite's 8 virtual devices gets a per-device batch of 1 where the port
    (one device) gets 8, so both train on the same global batch."""
    work = twist_work
    state = port_train.train(_twist_overrides(work, work / "port", 8,
                                              **{"training_args.use_cpu": "true"}))
    _jax_cli("train").train(_twist_overrides(work, work / "jax", 1))
    got, want = _history(work / "port", 3), _history(work / "jax", 3)
    assert state.global_step == 3 and len(_pick(got, "loss")) == 3
    np.testing.assert_allclose(_pick(got, "loss"), _pick(want, "loss"), rtol=1e-4)
    np.testing.assert_allclose(_pick(got, "eval_loss"), _pick(want, "eval_loss"), rtol=1e-4)
    np.testing.assert_allclose(_pick(got, "learning_rate"), _pick(want, "learning_rate"),
                               rtol=1e-6)
    assert _pick(got, "num_input_tokens_seen") == _pick(want, "num_input_tokens_seen")

    # the export loads in JAX: the same weights, the OPT decoder, the same scores
    ckpt = str(work / "port" / "checkpoint-3")
    port = UnitLM.from_pretrained(ckpt, device="cpu")
    back = JaxUnitLM.from_pretrained(ckpt)
    cfg = port.decoder.cfg
    assert (cfg.pos, cfg.learned_pos_offset, cfg.norm, cfg.act, cfg.num_heads,
            cfg.num_kv_heads, cfg.hidden_size, cfg.num_layers, str(cfg.compute_dtype)) == (
        "learned", 2, "layernorm", "relu", 12, 12, 768, 2, "torch.float32")
    with np.load(pathlib.Path(ckpt) / "params.npz") as flat:
        saved = {k: flat[k] for k in flat.files}
    jax_params = {k: np.asarray(v) for k, v in _flatten(back.params).items()}
    assert sorted(jax_params) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(jax_params[k], v, err_msg=k)
    tokens = np.array([[1, 7, 9, 11, 13, 1, 0, 0], [1, 400, 3, 2, 99, 7, 8, 1]])
    np.testing.assert_allclose(port.log_likelihood(tokens).numpy(),
                               np.asarray(back.log_likelihood(tokens)), atol=1e-4)


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(str(ROOT))
    return mod


def test_chip_smoke_f32_training_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """Phase 13 end to end on the CPU at a 2-layer width and context 64:
    each run takes its steps, the resumed runs repeat the last step bit for
    bit (loss, eval loss, weights), DPO's step 1 is ln 2, and no kernel
    launch is counted."""
    narrow = lambda kv: ["model.context_len=64"] + [
        f"+model.config_args.{k}={v}" for k, v in dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=kv, head_dim=16, intermediate_size=128).items()]
    result = chip_smoke.run_f32_training(
        torch.device("cpu"), "cpu rehearsal", tmp_path, twist_overrides=narrow(4),
        slam_overrides=narrow(2), n_rows=24, lengths=(10, 40), batch=2, accum=2,
        n_pref=4, n_pref_val=2, dpo_batch=2, prompt_len=10, completion_len=5)
    assert result["launches"] == {"flash_fwd_f32": 0, "flash_bwd_f32": 0}
    assert (result["twist"]["layers"], result["twist"]["remat"]) == (2, False)
    assert (result["slam"]["layers"], result["slam"]["remat"]) == (2, True)
    assert result["dpo"]["losses"][0] == pytest.approx(np.log(2), abs=1e-6)
    for name in ("twist", "slam"):
        assert result[name]["card_vs_cpu"]["max_grad_rel_err"] == 0.0
    json.dumps(result)
    out = capsys.readouterr().out
    assert "twist resumed: step 2" in out and "checkpoint-4 weights bitwise equal: True" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["f32_tokens.jsonl", "f32_val.jsonl", "f32_pref_train.jsonl", "f32_pref_val.jsonl"])
