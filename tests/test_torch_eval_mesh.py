"""Evaluation spread over the 'data' axis of gloo ranks on the CPU
(`UnitLM.shard`, `cli.eval eval_mesh=N`), against one process.

  * `UnitLM.shard(make_mesh())` on 2 and 3 ranks: `log_likelihood` of a
    batch of 5 rows (so the last rank holds pad rows, which are dropped),
    mean, summed and with ignored ids, and `generate` greedy, sampled (top-k,
    temperature) and penalised (top-p, repetition penalty, a banned id)
    equal one process bit for bit on every rank: each rank scores its rows
    through the same float32 ops, and a sampled step draws from the
    gathered [B, V] logits with the one generator every rank seeds alike.
    The scores equal the JAX `UnitLM.shard` on a 2-device data mesh within
    1e-5.
  * `cli.eval metric=sblimp eval_mesh=2` under `torchrun --standalone
    --nproc_per_node 2` prints one process's numbers, and only rank 0
    prints them.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.parallel import Mesh

import torch_mesh_workers

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_LM = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=502, twist_init=False,
               torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))


def _batches(seed=0, n=5):
    """n right-padded token rows of 20-90 ids and n left-padded prompts of
    3-12 ids (pad 0)."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((n, 90), np.int32)
    prompts = np.zeros((n, 12), np.int32)
    for i in range(n):
        k = int(rng.integers(20, 91))
        tokens[i, :k] = rng.integers(2, 502, k)
        p = int(rng.integers(3, 13))
        prompts[i, 12 - p:] = rng.integers(2, 502, p)
    return tokens, prompts


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_mesh") / "ckpt"
    UnitLM(UnitLMConfig(**TINY_LM), seed=0, device="cpu").save_pretrained(str(d))
    return d


@pytest.mark.parametrize("ranks", [2, 3])
def test_sharded_scoring_and_generation_equal_one_process(tmp_path, ckpt, ranks):
    tokens, prompts = _batches()
    got = torch_mesh_workers.launch("eval_mesh", ranks, tmp_path, ckpt=str(ckpt),
                                    tokens=tokens.tolist(), prompts=prompts.tolist())
    want = torch_mesh_workers.eval_calls(UnitLM.from_pretrained(str(ckpt), device="cpu"),
                                         tokens, prompts)
    assert want["ll"].shape == (5,) and want["sampled"].shape == (5, 18)
    assert not np.array_equal(want["sampled"], want["greedy"])
    for rank in got:
        assert sorted(rank) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(rank[k], want[k], err_msg=k)
    # the scores, against the JAX package's sharded UnitLM
    jax_tlm = JaxUnitLM.from_pretrained(str(ckpt)).shard(
        JaxMesh(np.array(jax.devices()[:2]), ("data",)))
    np.testing.assert_allclose(got[0]["ll"], np.asarray(jax_tlm.log_likelihood(tokens)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0]["ll_sum"],
                               np.asarray(jax_tlm.log_likelihood(tokens, mean_nll=False)),
                               rtol=1e-5, atol=1e-4)


def test_row_tiles_pad_and_drop_as_jax_does():
    """5 rows over 2 ranks: 3 a rank, the last row of rank 1 a pad row
    filled with the pad id; every rank's rows cover the batch once."""
    tiles = [Mesh(("data",), (2,), rank=r).row_tile(5) for r in range(2)]
    assert [(t.lo, t.hi, t.total) for t in tiles] == [(0, 3, 5), (3, 6, 5)]
    x = torch.arange(10).view(5, 2)
    assert torch.equal(tiles[1].mine(x, -1), torch.tensor([[6, 7], [8, 9], [-1, -1]]))
    with pytest.raises(ValueError, match="'data' only"):
        Mesh(("data", "seq"), (1, 2)).row_tile(5)


def test_shard_refuses_what_is_not_ported(ckpt, caplog):
    """A 'seq' axis is refused; fsdp=True and tp=True are ported: on one
    rank each is the unsharded model (the ranks' sharding:
    tests/test_torch_fsdp.py, tests/test_torch_tp_eval.py and
    tests/test_torch_tp_fsdp.py), and both together take tp alone, fsdp
    dropped with a warning, as the JAX `shard` drops it (item 28)."""
    from slamkit_tpu_torch.parallel.fsdp import is_sharded
    from slamkit_tpu_torch.parallel.tensor import is_tp

    tlm = UnitLM.from_pretrained(str(ckpt), device="cpu")
    assert tlm.shard(Mesh(("data",), (1,)), fsdp=True) is tlm
    assert not is_sharded(tlm.decoder) and tlm._row_tile(5) is None
    assert tlm.shard(Mesh(("data", "model"), (1, 1)), tp=True) is tlm
    assert not is_tp(tlm.decoder) and tlm._row_tile(5) is None
    with caplog.at_level("WARNING", logger="slamkit_tpu_torch.models.unit_lm"):
        assert tlm.shard(Mesh(("data", "model"), (1, 1)), fsdp=True, tp=True) is tlm
    assert [r.getMessage() for r in caplog.records if "drops fsdp=True" in r.getMessage()]
    assert not is_sharded(tlm.decoder) and not is_tp(tlm.decoder)
    with pytest.raises(ValueError, match="'data' and 'model'"):
        tlm.shard(Mesh(("data", "seq"), (1, 2)))
    assert tlm.shard(Mesh(("data",), (1,))) is tlm and tlm._row_tile(5) is None


def _sblimp_files(d):
    """Six seeded sBLIMP pairs, a tiny random HuBERT directory and 500
    centroids drawn from its own features."""
    from slamkit_tpu_torch.feature_extractor import HubertConfig
    from slamkit_tpu_torch.feature_extractor.hubert import forward, random_params, save_hf_dir
    from slamkit_tpu_torch.utils.audio import load_audio, save_wav
    from slamkit_tpu_torch.utils.tree import to_torch

    rng = np.random.default_rng(3)
    pairs = d / "sblimp"
    pairs.mkdir()
    for i in range(12):
        t = np.arange(int(rng.integers(4800, 9600))) / 16000
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + \
            0.05 * rng.standard_normal(t.size)
        save_wav(str(pairs / f"{i}+{'p' if i % 2 == 0 else 'n'}.wav"), wav)
    cfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                       hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=64, num_conv_pos_embeddings=8,
                       num_conv_pos_embedding_groups=4)
    params = random_params(cfg, seed=0)
    save_hf_dir(str(d / "hubert"), params, cfg)
    tparams = to_torch(params, torch.device("cpu"))
    frames = np.concatenate([
        forward(tparams, cfg, torch.from_numpy(load_audio(str(p)))[None], tap_layer=2)[0].numpy()
        for p in sorted(pairs.glob("*.wav"))])
    np.save(d / "km.npy", frames[rng.choice(len(frames), 500)].astype(np.float32))


def test_eval_cli_under_torchrun_prints_one_process_numbers(tmp_path, ckpt, fsdp=False):
    """`eval_mesh=2` (with `fsdp`, `eval_fsdp=true`: the weights sharded
    too) prints the one-process numbers."""
    _sblimp_files(tmp_path)
    ov = [f"model.pretrained_model={ckpt}", "model.config_args.torch_dtype=float32",
          "metric=sblimp", f"metric.data_path={tmp_path / 'sblimp'}", "metric.subfolder=false",
          f"tokeniser.feature_extractor.pretrained_model={tmp_path / 'hubert'}",
          f"tokeniser.feature_extractor.kmeans_path={tmp_path / 'km.npy'}",
          "tokeniser.feature_extractor.layer=2", "batch_size=3", "device=cpu"]
    cli = ["-m", "slamkit_tpu_torch.cli.eval"]
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    runs = {"mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "2", *cli, *ov, "eval_mesh=2",
                     f"eval_fsdp={str(fsdp).lower()}"],
            "one": [sys.executable, *cli, *ov]}
    printed = {}
    for name, cmd in runs.items():
        proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-4000:])
        printed[name] = [line for line in proc.stdout.splitlines() if ":" in line]
    assert printed["one"] and printed["mesh"] == printed["one"]


def test_eval_cli_fsdp_under_torchrun_prints_one_process_numbers(tmp_path, ckpt):
    test_eval_cli_under_torchrun_prints_one_process_numbers(tmp_path, ckpt, fsdp=True)
