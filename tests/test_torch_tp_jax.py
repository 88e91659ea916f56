"""Tensor parallelism over 'model' (`parallel/tensor.py`) on gloo ranks on
the CPU, against the JAX package's tensor parallelism on the suite's CPU
devices (`slamkit_tpu/parallel/mesh.py` `tp_shardings`), from the same
numpy weights (`models/convert.py`), in float32.

  * The plan: each parameter is split on the dim JAX's `tp_shardings`
    puts 'model' on in `make_mesh([4, 2])` (the stacked layer axis
    dropped), or kept whole where JAX keeps it whole, and each rank holds
    that slice's shape (a pythia-14m-shaped decoder: 4 / 4 heads, LayerNorm
    biases, parallel residual, partial rotary, an untied head; a
    Qwen-shaped one: GQA 4 / 2, tied embeddings, qkv bias, RMSNorm; and one
    whose vocabulary 'model' = 2 does not divide).
  * The forward: the port's [1, 2] and [2, 2] logits, gathered, equal the
    JAX `forward` jitted under `tp_shardings` on [4, 2] within 1e-5.
  * Training: the port's `SLAMTrainer` on [2, 2] (AdamW) and [1, 2]
    (Adafactor, 128 wide) equals the JAX `SLAMTrainer` on mesh [4, 2] with
    the same global batch (`tests/test_trainer.py:341`'s setup) within rtol
    2e-4, losses and eval losses, with max_grad_norm 0.05 so that clipping
    fires on every step (dropout 0, JAX on its plain attention).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from slamkit_tpu.data.dataset import TokenDataset as JaxTokenDataset
from slamkit_tpu.models.transformer import forward as jax_forward
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from slamkit_tpu.parallel.mesh import tp_shardings
from slamkit_tpu.trainer import SLAMTrainer as JaxSLAMTrainer
from slamkit_tpu_torch.parallel.tensor import tp_plan

import torch_mesh_workers
from test_torch_fsdp_jax import _jax_args_node
from torch_fsdp_cases import (CONFIG, CONTEXT, EVAL, GLOBAL_ROWS, TRAIN, WIDE, save_params,
                              train_args)

torch.set_num_threads(1)

QWEN = {**CONFIG, "dropout": 0.0, "vocab_size": 64}
PYTHIA = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
              torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))
DECODERS = {"pythia": PYTHIA, "qwen": QWEN, "odd_vocab": {**QWEN, "vocab_size": 63}}


def _jax_specs(params, mesh) -> dict:
    """flat JAX name -> the PartitionSpec `tp_shardings` gives its leaf."""
    tree = tp_shardings(params, mesh)
    return {"/".join(p.key for p in path): sh.spec
            for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _model_dim(spec, stacked: bool):
    """The dim of a port parameter that a JAX spec puts 'model' on."""
    dims = [i for i, a in enumerate(spec) if a == "model"]
    return None if not dims else dims[0] - int(stacked)


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_tp_plan_and_forward_match_jax_tp_shardings(tmp_path, decoder):
    cfg = DECODERS[decoder]
    jax_model = JaxUnitLM(JaxUnitLMConfig(**{**cfg, "attn_implementation": "xla"}), seed=0)
    flat = _flatten(jax_model.params)
    mesh = jax_make_mesh([4, 2])
    specs = _jax_specs(jax_model.params, mesh)
    L = jax_model.decoder.num_layers
    port_shapes = {(f"layers.{i}.{k[7:]}" if k.startswith("layers/") else k):
                   tuple(v.shape[1:] if k.startswith("layers/") else v.shape)
                   for k, v in flat.items() for i in (range(L) if k.startswith("layers/") else [0])}
    plan = tp_plan(port_shapes, 2)
    for name, dim in plan.items():
        key = f"layers/{name.split('.', 2)[2]}" if name.startswith("layers.") else name
        assert dim == _model_dim(specs[key], name.startswith("layers.")), name
    assert (plan["embed"] is None) == (decoder == "odd_vocab")

    ids = (np.arange(64, dtype=np.int32).reshape(4, 16) * 7) % cfg["vocab_size"]
    shardings = tp_shardings(jax_model.params, mesh)
    want = jax.jit(lambda p, x: jax_forward(p, jax_model.decoder, x)[0],
                   in_shardings=(shardings, NamedSharding(mesh, P("data"))))(
        jax.device_put(jax_model.params, shardings), jnp.asarray(ids))
    params_path = save_params(tmp_path, flat)
    for shape in ([1, 2], [2, 2]):
        got = torch_mesh_workers.launch("tp_forward", int(np.prod(shape)),
                                        tmp_path / f"ranks{shape[0]}", config=cfg,
                                        params_path=params_path, ids=ids.tolist(),
                                        mesh_shape=shape)
        for rank, out in enumerate(got):
            np.testing.assert_allclose(out["logits"], np.asarray(want), rtol=1e-5, atol=1e-5)
            model_rank = rank % 2
            for name, dim in plan.items():
                whole = port_shapes[name]
                local = tuple(out[f"shape/{name}"])
                assert local == tuple(n // 2 if i == dim else n for i, n in enumerate(whole)), \
                    (name, model_rank)


@pytest.mark.parametrize("optim,port_shape", [("adamw_torch", [2, 2]), ("adafactor", [1, 2])])
def test_tp_losses_match_the_jax_tp_trainer(tmp_path, optim, port_shape):
    """The port on `port_shape` and the JAX SLAMTrainer with mesh_shape
    [4, 2] (attn xla), same weights and global batch, dropout 0,
    max_grad_norm 0.05; Adafactor at 128 wide."""
    cfg = {**CONFIG, "dropout": 0.0}
    if optim == "adafactor":
        cfg["config_overrides"] = WIDE
    extra = dict(optim=optim, max_grad_norm="0.05")
    jax_model = JaxUnitLM(JaxUnitLMConfig(**{**cfg, "attn_implementation": "xla"}), seed=0)
    flat = _flatten(jax_model.params)
    jax_rows = GLOBAL_ROWS // 4
    want = JaxSLAMTrainer(jax_model, _jax_args_node(tmp_path / "jax", mesh_shape="[4,2]",
                                                    per_device_train_batch_size=jax_rows,
                                                    per_device_eval_batch_size=jax_rows,
                                                    **extra),
                          JaxTokenDataset.from_lists(TRAIN),
                          eval_dataset=JaxTokenDataset.from_lists(EVAL), packing=True,
                          context_len=CONTEXT).train().log_history
    rows = GLOBAL_ROWS // port_shape[0]
    args = train_args(tmp_path / "mesh", mesh_shape=str(port_shape).replace(" ", ""),
                      mesh_axes="[data,model]", per_device_train_batch_size=rows,
                      per_device_eval_batch_size=rows, **extra)
    got = torch_mesh_workers.launch("train", int(np.prod(port_shape)), tmp_path / "ranks",
                                    config=cfg, args=args, train_seqs=TRAIN, eval_seqs=EVAL,
                                    context_len=CONTEXT, params_path=save_params(tmp_path, flat))
    want_loss = [r["loss"] for r in want if "loss" in r]
    want_eval = [r["eval_loss"] for r in want if "eval_loss" in r]
    assert len(want_loss) == 2 and len(want_eval) == 2
    # clipping fires on both steps: the global norm of the gradients the
    # port's optimizer read (gathered whole) is above max_grad_norm
    for i in range(2):
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for k, v in got[0].items() if k.startswith(f"a/grad{i}/")))
        assert norm > 0.05
    for rank in got:
        np.testing.assert_allclose(rank["a/loss"], want_loss, rtol=2e-4)
        np.testing.assert_allclose(rank["a/eval_loss"], want_eval, rtol=2e-4)
