"""Evaluation and DPO on a ('data', 'model') mesh of gloo ranks on the CPU,
against one process.

  * `UnitLM.shard(mesh, tp=True)` on [1, 2] and [2, 2] (a pythia-14m-shaped
    decoder, float32): `log_likelihood` of a batch of 5 rows, mean, summed
    and with ignored ids, equals one process within 1e-5 (the vocab-parallel
    NLL and the row-parallel sums add in another order); `generate` greedy,
    sampled (top-k, temperature) and penalised (top-p, repetition penalty, a
    banned id) give one process's tokens on every rank: each rank of a
    'model' line samples from the gathered last-position logits with the
    generator every rank seeds alike.
  * int8 generation under tp: each projection is quantized whole, so every
    rank's q and s are the slices of the unsharded int8 copy bit for bit (a
    column-parallel weight its columns of both, a row-parallel one its rows
    of q and the whole s). The row-parallel products sum the ranks' bf16
    partial outputs, one rounding more than one product; the int8 prefill's
    last-position logits stay within `tools/parallel_smoke.int8_tp_atol`
    of one process's (sqrt(2 x layers) bf16 ulps of the largest logit), and
    the int8 greedy tokens are one process's.
  * `SLAMDPOTrainer` on [1, 2] keeps the parameters whole and runs the same
    pairs on both ranks: it equals one process within 1e-5 and resumes
    exactly.
"""
import numpy as np
import pytest
import torch

from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.models.generate import _QUANT_KEYS
from slamkit_tpu_torch.tools.parallel_smoke import int8_tp_atol

import torch_mesh_workers
from test_torch_eval_mesh import TINY_LM, _batches
from test_torch_parallel_dpo import CONFIG as DPO_CONFIG
from test_torch_parallel_dpo import EVAL as DPO_EVAL
from test_torch_parallel_dpo import GLOBAL_PAIRS
from test_torch_parallel_dpo import TRAIN as DPO_TRAIN
from test_torch_parallel_dpo import _args_node, one_process
from torch_mesh_workers import DPO_KEYS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_eval") / "ckpt"
    UnitLM(UnitLMConfig(**TINY_LM), seed=0, device="cpu").save_pretrained(str(d))
    return d


@pytest.mark.parametrize("shape", [[1, 2], [2, 2]])
def test_tp_scoring_and_generation_equal_one_process(tmp_path, ckpt, shape):
    tokens, prompts = _batches()
    got = torch_mesh_workers.launch("eval_mesh", int(np.prod(shape)), tmp_path / "ranks",
                                    ckpt=str(ckpt), tokens=tokens.tolist(),
                                    prompts=prompts.tolist(), tp_shape=shape)
    want = torch_mesh_workers.eval_calls(UnitLM.from_pretrained(str(ckpt), device="cpu"),
                                         tokens, prompts, int8=True)
    for rank in got:
        assert sorted(rank) == sorted(want)
        for k in ("ll", "ll_sum", "ll_ignore"):
            np.testing.assert_allclose(rank[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("greedy", "int8", "sampled", "penalised"):
            np.testing.assert_array_equal(rank[k], want[k], err_msg=k)


def test_tp_int8_quantizes_whole_and_keeps_slices(tmp_path, ckpt):
    _, prompts = _batches()
    got = torch_mesh_workers.launch("tp_int8", 2, tmp_path / "ranks", ckpt=str(ckpt),
                                    prompts=prompts.tolist(), mesh_shape=[1, 2])
    tlm = UnitLM.from_pretrained(str(ckpt), device="cpu")
    dec = tlm._int8_decode_params()
    with torch.inference_mode():
        want = dec(torch.tensor(prompts))[0][:, -1].numpy()
    for rank, out in enumerate(got):
        for i, layer in enumerate(dec.layers):
            for key in _QUANT_KEYS:
                w = getattr(layer, key, None)
                if not isinstance(w, dict):
                    continue
                q, s = w["q"].float().numpy(), w["s"].float().numpy()
                if key in ("o_w", "down_w"):   # rows of q, the whole s
                    rows = q.shape[0] // 2
                    want_q, want_s = q[rank * rows:(rank + 1) * rows], s
                else:                          # columns of q and s
                    cols = q.shape[1] // 2
                    want_q = q[:, rank * cols:(rank + 1) * cols]
                    want_s = s[:, rank * cols:(rank + 1) * cols]
                np.testing.assert_array_equal(out[f"q/{i}/{key}"], want_q, err_msg=key)
                np.testing.assert_array_equal(out[f"s/{i}/{key}"], want_s, err_msg=key)
        np.testing.assert_allclose(out["logits"], want, rtol=0,
                                   atol=int8_tp_atol(want, len(dec.layers)))


def test_tp_mesh_dpo_equals_one_process_and_resumes_exactly(tmp_path):
    args = _args_node(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_PAIRS,
                      mesh_shape="[1,2]", mesh_axes="[data,model]")
    got = torch_mesh_workers.launch("dpo", 2, tmp_path / "ranks", config=DPO_CONFIG,
                                    args=args, train_rows=DPO_TRAIN, eval_rows=DPO_EVAL)
    want, want_grads, want_params = one_process(tmp_path / "one", DPO_CONFIG)
    for rank in got:
        for key in DPO_KEYS:
            np.testing.assert_allclose(rank[f"a/{key}"], want[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
            np.testing.assert_array_equal(rank[f"b/{key}"], rank[f"a/{key}"], err_msg=key)
        for i, grads in enumerate(want_grads):
            for k, g in grads.items():
                np.testing.assert_allclose(rank[f"a/grad{i}/{k}"], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max(), err_msg=f"{k} step {i}")
        for k, v in want_params.items():
            np.testing.assert_allclose(rank[f"a/param/{k}"], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)
            np.testing.assert_array_equal(rank[f"a/param/{k}"], got[0][f"a/param/{k}"])
