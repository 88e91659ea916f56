"""The port's Adafactor against the JAX package's `make_optimizer` chain
(optax `scale_by_factored_rms` + `scale_by_param_block_rms`): 20 updates fed
the same gradients land on the same parameters, for factored parameters (two
axes of >= 128 entries, either one the larger) and unfactored ones (1-D, a
small 2-D), with clipping on and off, with and without weight decay, under
the cosine schedule; the state resumes exactly; the optimizer kind guards a
resume; and `cli.train training_args.optim=adafactor` takes 2 steps.

Tolerance: parameters after 20 steps within 1e-6 absolute and relative. Both
sides compute in float32, but the row and column means and the parameter's
RMS are sums in another order (~1e-7 relative each), and the factored scale
is their quotient's inverse square root, which leaves each step's update
within a few float32 roundings of optax's.
"""
import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slamkit_tpu.trainer.optim import make_optimizer as jax_make_optimizer
from slamkit_tpu_torch.trainer.optim import AdamW, Adafactor, make_optimizer

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


class _Args(dict):
    """The JAX make_optimizer reads attributes as well as keys."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w_tall": rng.standard_normal((256, 128)).astype(np.float32),   # factored, d0 = 0
            "w_wide": (0.01 * rng.standard_normal((128, 160))).astype(np.float32),  # d0 = 1
            "w_small": rng.standard_normal((5, 300)).astype(np.float32),    # unfactored 2-D
            "b": rng.standard_normal((7,)).astype(np.float32),               # unfactored 1-D
            "tiny": np.full((3,), 1e-4, np.float32)}                         # rms below 1e-3


def _args(max_grad_norm, weight_decay):
    return {"learning_rate": 1e-2, "lr_scheduler_type": "cosine_with_min_lr",
            "lr_scheduler_kwargs": {"min_lr": 1e-3}, "warmup_steps": 3,
            "max_grad_norm": max_grad_norm, "weight_decay": weight_decay,
            "optim": "adafactor"}


def _grads(rng, init, step):
    return {k: (rng.standard_normal(v.shape) * (0.1 + step % 3)).astype(np.float32)
            for k, v in init.items()}


@pytest.mark.parametrize("max_grad_norm,weight_decay", [(0.5, 0.0), (1e4, 0.1)])
def test_twenty_updates_match_optax(max_grad_norm, weight_decay):
    args = _args(max_grad_norm, weight_decay)
    init = _params(0)
    tx, _ = jax_make_optimizer(_Args(args), total_steps=20)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, _ = make_optimizer(args, list(tparams.values()), total_steps=20)
    assert isinstance(opt, Adafactor)
    assert [d is not None for d in opt.dims] == [True, True, False, False, False]
    rng = np.random.default_rng(1)
    clipped = 0
    for step in range(20):
        grads = _grads(rng, init, step)
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        clipped += int(opt.step().item() >= max_grad_norm)
        for k in init:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       err_msg=f"step {step} {k}", **TOL)
    assert (clipped > 0) == (max_grad_norm < 1)
    # the factored statistics against optax's state (chain index 1)
    fac = jstate[1]
    for i, k in enumerate(init):
        if opt.dims[i] is not None:
            np.testing.assert_allclose(opt.v_row[i].numpy(), np.asarray(fac.v_row[k]), rtol=1e-5)
            np.testing.assert_allclose(opt.v_col[i].numpy(), np.asarray(fac.v_col[k]), rtol=1e-5)
        else:
            np.testing.assert_allclose(opt.v[i].numpy(), np.asarray(fac.v[k]), rtol=1e-5)
    assert int(fac.count) == opt.step_count == 20


def test_state_resumes_exactly():
    """10 steps, a state_dict round trip through torch.save into a fresh
    optimizer, 10 more: bitwise the 20 straight steps."""
    import io

    args = _args(0.5, 0.1)
    init = _params(2)
    rng_grads = [_grads(np.random.default_rng(3), init, s) for s in range(20)]

    def run(steps, params, opt):
        for g in steps:
            for k, p in params.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
            opt.zero_grad()

    def fresh():
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
        return params, make_optimizer(args, list(params.values()), total_steps=20)[0]

    straight, opt = fresh()
    run(rng_grads, straight, opt)
    first, opt1 = fresh()
    run(rng_grads[:10], first, opt1)
    buf = io.BytesIO()
    torch.save({"params": {k: p.detach() for k, p in first.items()}, **opt1.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    resumed, opt2 = fresh()
    with torch.no_grad():
        for k, p in resumed.items():
            p.copy_(saved["params"][k])
    opt2.load_state_dict(saved)
    run(rng_grads[10:], resumed, opt2)
    for k in init:
        assert torch.equal(resumed[k], straight[k]), k


def test_kind_is_recorded_and_guards_a_resume():
    p = [torch.nn.Parameter(torch.ones(3))]
    ada, _ = make_optimizer({"learning_rate": 1e-3, "optim": "adafactor"}, p, 10)
    adam, _ = make_optimizer({"learning_rate": 1e-3}, p, 10)
    assert isinstance(adam, AdamW)
    assert ada.state_dict()["kind"] == "adafactor" and adam.state_dict()["kind"] == "adamw"
    with pytest.raises(ValueError, match="adamw.*adafactor"):
        ada.load_state_dict(adam.state_dict())
    with pytest.raises(ValueError, match="adafactor.*adamw"):
        adam.load_state_dict(ada.state_dict())
    # an AdamW state written before the kind was recorded
    legacy = {k: v for k, v in adam.state_dict().items() if k != "kind"}
    adam.load_state_dict(copy.deepcopy(legacy))
    with pytest.raises(ValueError, match="adamw"):
        ada.load_state_dict(legacy)


def test_cli_train_with_adafactor(tmp_path):
    """`cli.train training_args.optim=adafactor` takes 2 finite steps, and
    its checkpoint holds Adafactor's state."""
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus

    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 24, (20, 60))
    state = cli_train.train([
        "model=slam", "model.context_len=64", "model.config_args.torch_dtype=float32",
        "+model.config_args.num_hidden_layers=2", f"data.train_path={tokens}",
        f"data.val_path={tokens}", "data.packing=true", "training_args.optim=adafactor",
        f"training_args.output_dir={tmp_path / 'run'}", "training_args.max_steps=2",
        "training_args.per_device_train_batch_size=2", "training_args.logging_steps=1",
        "training_args.use_cpu=true"])
    assert state.global_step == 2
    losses = [r["loss"] for r in state.log_history if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    saved = torch.load(tmp_path / "run" / "checkpoint-2" / "state" / "train_state.pt",
                       weights_only=True)
    assert saved["kind"] == "adafactor" and saved["step"] == 2
