"""The port's schedules and AdamW against the JAX package's `make_schedule` and
optax chain: the same learning rate at every step of all five schedules, the
warmup rule, and 20 updates fed the same gradients landing on the same
parameters with float32 and bfloat16 moments, clipping on and off, with and
without weight decay.

Tolerances: schedules 1e-6 relative, or 1e-6 of the peak rate near zero
(optax evaluates them in float32, the port in float64); parameters after 20
steps 1e-6 absolute and relative at float32 moments (float32 arithmetic in
both, some orders of summation differ), and at bfloat16 moments 1e-5 (a
moment that rounds to the other side of a bf16 step moves an update by 2^-8
of itself).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slamkit_tpu.trainer.optim import make_optimizer as jax_make_optimizer
from slamkit_tpu.trainer.optim import make_schedule as jax_make_schedule
from slamkit_tpu.trainer.optim import resolve_warmup_steps as jax_warmup
from slamkit_tpu_torch.trainer.optim import make_optimizer, make_schedule, resolve_warmup_steps

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["linear", "cosine", "cosine_with_min_lr", "constant",
                                  "constant_with_warmup"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_schedules_match_optax(kind, warmup):
    want = jax_make_schedule(kind, 1e-3, 50, warmup_steps=warmup, min_lr=5e-5)
    got = make_schedule(kind, 1e-3, 50, warmup_steps=warmup, min_lr=5e-5)
    for step in range(0, 56):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-9,
                                   err_msg=f"step {step}")


def test_warmup_rule_and_cosine_min_lr():
    for args in ((100, 0.01, 1000), (100, 0.01, 100000), (0, 0.0, 10), (3, 0.5, 9)):
        assert resolve_warmup_steps(*args) == jax_warmup(*args)
    s = make_schedule("cosine_with_min_lr", 1e-3, 1000, warmup_steps=100, min_lr=5e-5)
    assert s(0) == pytest.approx(0.0)
    assert s(100) == pytest.approx(1e-3, rel=1e-3)
    assert s(1000) == pytest.approx(5e-5, rel=1e-3)
    assert s(550) < 1e-3


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_grad_norm,weight_decay", [(0.5, 0.0), (100.0, 0.1)])
def test_twenty_updates_match_optax(state_dtype, max_grad_norm, weight_decay):
    args = {"learning_rate": 1e-2, "lr_scheduler_type": "cosine_with_min_lr",
            "lr_scheduler_kwargs": {"min_lr": 1e-3}, "warmup_steps": 3,
            "max_grad_norm": max_grad_norm, "weight_decay": weight_decay,
            "optim": "adamw_torch", "optim_state_dtype": state_dtype}
    init = _params(0)
    tx, _ = jax_make_optimizer(_Args(args), total_steps=20)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, _ = make_optimizer(args, list(tparams.values()), total_steps=20)
    rng = np.random.default_rng(1)
    clipped = 0
    for step in range(20):
        grads = {k: (rng.standard_normal(v.shape) * (0.1 + step % 3)).astype(np.float32)
                 for k, v in init.items()}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        clipped += int(opt.step().item() >= max_grad_norm)
        tol = dict(rtol=1e-6, atol=1e-6) if state_dtype == "float32" else \
            dict(rtol=1e-5, atol=1e-5)
        for k in init:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       err_msg=f"step {step} {k}", **tol)
    assert (clipped > 0) == (max_grad_norm < 1)
    assert opt.exp_avg[0].dtype == getattr(torch, state_dtype)


def test_adafactor_and_unknown_optimizers_raise():
    """Unknown optimizers and moment dtypes raise (adafactor is ported:
    tests/test_torch_adafactor.py)."""
    base = {"learning_rate": 1e-3}
    with pytest.raises(ValueError, match="optim"):
        make_optimizer({**base, "optim": "sgd"}, [], 10)
    with pytest.raises(ValueError, match="optim_state_dtype"):
        make_optimizer({**base, "optim_state_dtype": "float16"}, [], 10)


class _Args(dict):
    """The JAX make_optimizer reads attributes as well as keys."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None
