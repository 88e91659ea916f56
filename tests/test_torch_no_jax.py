"""The port stands without JAX (serving, and training two steps with a save),
and `chip_smoke.py` refuses to run without a card: no CPU fallback can pass
for a GPU run."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX = r"""
import json, os, sys, tempfile
import torch
import slamkit_tpu_torch
import slamkit_tpu_torch.ops
from slamkit_tpu_torch.data import load_token_dataset
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.tokeniser import UnitTokeniser
from slamkit_tpu_torch.trainer import SLAMTrainer

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)
lm = UnitLM(UnitLMConfig(base_model_name="EleutherAI/pythia-14m", vocab_size=502,
                         twist_init=False, torch_dtype="float32", remat=True))
ll = lm.log_likelihood([[1, 5, 6, 7, 1, 0]])
out = lm.generate([[1, 5, 6]], max_new_tokens=3, seed=0)
assert torch.isfinite(ll).all() and out.shape == (1, 6)
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "tokens.jsonl"), "w") as f:
        for i in range(24):
            units = "".join(f"<Un{(7 * i + j) % 500}>" for j in range(5 + i))
            f.write(json.dumps({"file_name": str(i), "audio_repr": units}) + "\n")
    ds = load_token_dataset(os.path.join(d, "tokens.jsonl"), UnitTokeniser())
    args = {"output_dir": os.path.join(d, "out"), "per_device_train_batch_size": 2,
            "gradient_accumulation_steps": 2, "max_steps": 2, "learning_rate": 1e-3,
            "lr_scheduler_type": "cosine_with_min_lr", "lr_scheduler_kwargs": {"min_lr": 5e-5},
            "max_grad_norm": 0.5, "optim_state_dtype": "bfloat16", "save_steps": 2,
            "logging_steps": 1}
    state = SLAMTrainer(lm, args, ds, packing=True, context_len=64).train()
    assert state.global_step == 2, state
    assert os.path.isfile(os.path.join(d, "out", "checkpoint-2", "trainer_state.json"))
    assert os.path.isfile(os.path.join(d, "out", "checkpoint-2", "state", "train_state.pt"))
    UnitLM.from_pretrained(os.path.join(d, "out", "checkpoint-2"))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "slamkit_tpu.")))
print("LOADED", bad)
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"   # one thread beside the gate's other workers
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_and_runs_without_jax():
    proc = _run([sys.executable, "-c", _NO_JAX], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_port_sources_never_import_jax():
    for path in (ROOT / "slamkit_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "slamkit_tpu")), (path, line)


def test_chip_smoke_fails_without_cuda():
    proc = _run([sys.executable, "chip_smoke.py"], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(str(ROOT))
    return mod


def test_chip_smoke_tokenises_like_unit_tokeniser(chip_smoke):
    from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser, pad_token_batch

    rng = np.random.default_rng(0)
    reprs = chip_smoke._unit_strings(rng, [5, 17, 1, 9])
    tok = UnitTokeniser(load_fe=False)
    want = tok.string_tokenise(reprs, padding=True)["input_ids"]
    np.testing.assert_array_equal(chip_smoke.tokenise_units(reprs), want)
    # build_prompt: drop the trailing <S>, pad on the left
    prompts = pad_token_batch([tok._encode_one(s)[:-1] for s in reprs], tok.pad_token_id,
                              "left")["input_ids"]
    np.testing.assert_array_equal(chip_smoke.tokenise_units(reprs, prompt=True), prompts)


def test_chip_smoke_slice_rehearsal_on_cpu(chip_smoke, capsys):
    """The smoke's scoring and generation phases end to end on the CPU at a
    2-layer width: the plain attention runs and no kernel launch is counted."""
    import dataclasses

    import torch

    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    cfg = dataclasses.replace(slam_config(), torch_dtype="float32",
                              config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                                    num_attention_heads=4,
                                                    num_key_value_heads=2, head_dim=16,
                                                    intermediate_size=128))
    result = chip_smoke.run_slice(torch.device("cpu"), "cpu rehearsal", cfg=cfg)
    assert result["launches"] == 0
    assert result["nll_err"] < 1e-5
    assert set(result["generation"]) == {"sample", "greedy"}
    json.dumps(result)
    assert "scoring: 8 requests" in capsys.readouterr().out


def test_chip_smoke_training_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """The smoke's training and card-vs-CPU phases end to end on the CPU at a
    2-layer width: four steps with a save at step 3, a resumed run that
    repeats step 4, the export reloaded; no kernel launch is counted."""
    import dataclasses

    import torch

    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    cfg = dataclasses.replace(slam_config(), torch_dtype="float32",
                              config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                                    num_attention_heads=4,
                                                    num_key_value_heads=2, head_dim=16,
                                                    intermediate_size=128))
    cpu = torch.device("cpu")
    result = chip_smoke.run_training(cpu, "cpu rehearsal", cfg=cfg, work=tmp_path, n_rows=80,
                                     lengths=(10, 60), context_len=64,
                                     per_device_train_batch_size=2,
                                     gradient_accumulation_steps=2)
    assert result["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert result["resume_err"] == 0.0
    assert result["losses"][-1] < result["losses"][0]
    json.dumps(result)
    check = chip_smoke.check_card_vs_cpu(cpu, tmp_path, cfg=cfg, context=64)
    assert check["loss_err"] < 1e-5 and check["min_grad_cosine"] > 0.9999
    assert "resume from checkpoint-3" in capsys.readouterr().out
