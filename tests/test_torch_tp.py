"""Tensor parallelism over 'model' (Megatron; `parallel/tensor.py`) on gloo
ranks on the CPU, against the one-process run of the same global batch.

  * Training: `SLAMTrainer` on ('data', 'model') meshes [2, 2] and [1, 2]
    equals the one-process run within the tolerances of
    `test_torch_fsdp.py` (losses and eval losses 1e-5, the global gradient
    each optimizer step reads, gathered over 'model', within 1e-5 of its
    largest entry, every parameter 1e-5) for three decoders: Qwen-shaped
    (GQA 4 / 2, tied embeddings, qkv bias, RMSNorm), pythia-14m-shaped
    (4 / 4 heads, LayerNorm biases, parallel residual, partial rotary, an
    untied head) and one whose vocabulary 'model' = 2 does not divide (so
    embed and head stay whole); with dropout 0.1 everywhere, attention
    dropout and layerdrop on the plain attention, full and qkv remat,
    AdamW and Adafactor at 128 wide with clipping on every step. A second
    trainer resuming from checkpoint-1 on the same mesh repeats step 2 and
    the weights bit for bit, and every replicated parameter (norms, o_b,
    down_b, a whole vocabulary) is bitwise equal on the ranks of a 'model'
    line after two steps.
  * A checkpoint written under [2, 2] holds the one-process checkpoint's
    keys, shapes and dtypes, and one process resuming from it takes step 2
    within 1e-5 of the one-process run.
  * The raises: heads or kv heads that do not divide 'model' (naming
    ROADMAP queue 3). fsdp beside 'model' (item 28) no longer raises: on
    [1, 2] it shards nothing, and `UnitLM.shard(fsdp=True, tp=True)` takes
    TP alone with a warning. 'model' beside 'seq' (item 29) no longer
    raises either: the ('data', 'model', 'seq') mesh builds in both orders
    (`test_torch_tp_seq.py` trains on it).
"""
import json

import numpy as np
import pytest
import torch

from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.parallel.tensor import check_heads, tp_plan

import torch_mesh_workers
from torch_fsdp_cases import (CONFIG, CONTEXT, EVAL, GLOBAL_ROWS, TRAIN, WIDE, one_process,
                              seqs, train_args)

torch.set_num_threads(1)

PYTHIA = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
              torch_dtype="float32", dropout=0.1, config_overrides=dict(num_hidden_layers=2))
PYTHIA_TRAIN, PYTHIA_EVAL = seqs(60, 0, vocab=64), seqs(8, 1, vocab=64)
ODD = dict(CONFIG, vocab_size=501)

# case: (ranks, 'data' size, training_args overrides, config, corpora)
CASES = {
    "qwen_dp_tp_remat": (4, 2, dict(mesh_shape="[2,2]"), {**CONFIG, "remat": True}, None),
    "qwen_tp_qkv_remat": (2, 1, dict(mesh_shape="[1,2]"),
                          {**CONFIG, "remat": True, "remat_policy": "qkv"}, None),
    "pythia_dp_tp": (4, 2, dict(mesh_shape="[2,2]"), PYTHIA, (PYTHIA_TRAIN, PYTHIA_EVAL)),
    "pythia_dropouts": (2, 1, dict(mesh_shape="[1,2]"),
                        {**PYTHIA, "attention_dropout": 0.1, "layerdrop": 0.3,
                         "attn_implementation": "xla"}, (PYTHIA_TRAIN, PYTHIA_EVAL)),
    "odd_vocab": (2, 1, dict(mesh_shape="[1,2]"), ODD, (seqs(60, 0, 501), seqs(8, 1, 501))),
    "adafactor": (2, 1, dict(mesh_shape="[1,2]", optim="adafactor", max_grad_norm="0.05"),
                  {**CONFIG, "config_overrides": WIDE}, None),
}


def _replicated(config, size) -> list:
    """The parameter names `tp_plan` keeps whole on every rank."""
    model = UnitLM(UnitLMConfig(**config), seed=0, device="cpu")
    plan = tp_plan({n: tuple(p.shape) for n, p in model.decoder.named_parameters()}, size)
    return [n for n, dim in plan.items() if dim is None]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_equals_one_process_and_resumes_exactly(tmp_path, case):
    ranks, n_data, over, config, corpora = CASES[case]
    train, evals = corpora or (TRAIN, EVAL)
    optim = {k: v for k, v in over.items() if k in ("optim", "max_grad_norm")}
    args = train_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_ROWS // n_data,
                      per_device_eval_batch_size=GLOBAL_ROWS // n_data,
                      mesh_axes="[data,model]", **over)
    got = torch_mesh_workers.launch("train", ranks, tmp_path / "ranks", config=config,
                                    args=args, train_seqs=train, eval_seqs=evals,
                                    context_len=CONTEXT)
    want_loss, want_eval, want_grads, want_params = one_process(
        tmp_path / "one", config, train=train, evals=evals, **optim)
    assert len(want_loss) == 2 and len(want_eval) == 2 and len(want_grads) == 2
    if case == "adafactor":   # clipping fires on both steps
        for grads in want_grads:
            assert np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads.values())) > 0.05
    replicated = _replicated(config, 2)
    assert ("embed" in replicated) == (case == "odd_vocab")
    for rank in got:
        np.testing.assert_allclose(rank["a/loss"], want_loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rank["a/eval_loss"], want_eval, rtol=1e-5, atol=1e-5)
        for i, grads in enumerate(want_grads):
            for k, g in grads.items():
                np.testing.assert_allclose(rank[f"a/grad{i}/{k}"], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max(), err_msg=f"{k} step {i}")
        for k, v in want_params.items():
            np.testing.assert_allclose(rank[f"a/param/{k}"], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        assert list(rank["b/loss"]) == list(rank["a/loss"])
        assert list(rank["b/eval_loss"][-1:]) == list(rank["a/eval_loss"][-1:])
        for k in want_params:
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)
    # the ranks of each 'model' line (row-major: 2r, 2r + 1) hold bitwise
    # equal replicated parameters and different slices of the others
    for r in range(0, ranks, 2):
        for k in replicated:
            np.testing.assert_array_equal(got[r][f"a/local/{k}"], got[r + 1][f"a/local/{k}"],
                                          err_msg=k)
        assert not np.array_equal(got[r]["a/local/layers.0.q_w"],
                                  got[r + 1]["a/local/layers.0.q_w"])


@pytest.mark.parametrize("optim", ["adamw_torch", "adafactor"])
def test_tp_checkpoint_has_the_one_rank_layout_and_resumes_on_one_process(tmp_path, optim):
    config = {**CONFIG, "config_overrides": WIDE} if optim == "adafactor" else CONFIG
    args = train_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_ROWS // 2,
                      per_device_eval_batch_size=GLOBAL_ROWS // 2, mesh_shape="[2,2]",
                      mesh_axes="[data,model]", optim=optim)
    torch_mesh_workers.launch("train", 4, tmp_path / "ranks", config=config, args=args,
                              train_seqs=TRAIN, eval_seqs=EVAL, context_len=CONTEXT)
    want_loss, want_eval, _, want_params = one_process(tmp_path / "one", config, optim=optim)
    load = lambda out: torch.load(out / "checkpoint-1" / "state" / "train_state.pt",
                                  weights_only=True)
    split, single = load(tmp_path / "mesh"), load(tmp_path / "one")

    def layout(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype, x.device.type)
        if isinstance(x, dict):
            return {k: layout(v) for k, v in x.items()}
        if isinstance(x, list):
            return [layout(v) for v in x]
        return type(x)

    assert layout(split) == layout(single)
    assert split["kind"] == optim.split("_")[0] and split["step"] == 1
    for k, v in single["params"].items():
        np.testing.assert_allclose(split["params"][k].numpy(), v.detach().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    got_loss, got_eval, _, got_params = one_process(
        tmp_path / "resumed", config, resume=str(tmp_path / "mesh" / "checkpoint-1"),
        optim=optim)
    np.testing.assert_allclose(got_loss[-1], want_loss[-1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_eval[-1], want_eval[-1], rtol=1e-5, atol=1e-5)
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


# --------------------------------------------------------------------------- #
# what raises
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("heads,kv_heads,size", [(4, 2, 4), (6, 6, 4), (14, 2, 4)])
def test_heads_that_do_not_divide_raise_naming_queue_3(heads, kv_heads, size):
    from slamkit_tpu_torch.models.presets import DecoderConfig

    cfg = DecoderConfig(num_heads=heads, num_kv_heads=kv_heads)
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        check_heads(cfg, size)
    check_heads(cfg, 2)


def test_fsdp_beside_model_raises_naming_item_28(tmp_path):
    """What replaced the refusal (item 28, ported): on [1, 2] the trainer
    builds with fsdp=true, splits over 'model' and shards nothing over its
    one 'data' rank; `shard(fsdp=True, tp=True)` gives TP alone and warns
    that fsdp is dropped, as JAX drops it."""
    args = train_args(tmp_path / "out", per_device_train_batch_size=2, fsdp="true",
                      mesh_shape="[1,2]", mesh_axes="[data,model]")
    got = torch_mesh_workers.launch("fsdp_on_one_line", 2, tmp_path / "ranks", config=CONFIG,
                                    args=args, train_seqs=TRAIN, context_len=CONTEXT)
    for rank in got:
        assert rank["trainer"].tolist() == [True, False]
        assert rank["shard"].tolist() == [True, False]
        warnings = json.loads(str(rank["warnings"]))
        assert len(warnings) == 1 and "drops fsdp=True" in warnings[0], warnings


def test_model_beside_seq_raises_naming_item_29(tmp_path):
    """What replaced the refusal (item 29, ported): 'model' beside 'seq'
    builds in both orders on 4 gloo ranks; in ('data', 'seq', 'model') the
    'seq' lines are strided ({0, 2}, {1, 3}) and each is the batch group of
    its 'model' coordinate."""
    got = torch_mesh_workers.launch("mesh_groups", 4, tmp_path, shape=[1, 2, 2],
                                    orders=[["data", "model", "seq"], ["data", "seq", "model"]])
    assert [r["1/coordinate"].tolist() for r in got] == [[0, s, m] for s in range(2)
                                                         for m in range(2)]
    assert [r["1/seq"].tolist() for r in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [r["1/model"].tolist() for r in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    for i in range(2):
        assert [r[f"{i}/batch"].tolist() for r in got] == [r[f"{i}/seq"].tolist() for r in got]
