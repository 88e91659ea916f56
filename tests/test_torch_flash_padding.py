"""Head dims other than 64, 128 and 256 on the flash kernels: the
zero-padding in `slamkit_tpu_torch/ops/flash_attention.py::_launch` /
`_launch_bwd` on the CPU.

The kernels run only on the card, so the kernel calls under the launch
functions (`_launch_kernel` / `_launch_bwd_kernel`) are replaced here by the
kernels' plain versions (`mha_reference` / `mha_reference_bwd`) run on the
tensors they receive. At d = 32, 80, 96, 160, 192 and 256 (padded to 64,
128, 128, 256, 256 and not at all) the padded computation is held against
the same plain versions unpadded,
forward and backward, bf16 and float32, causal and non-causal, on packed
rows with a -1 tail. The zero columns add exact zeros to every product, so
only summation order may differ: float32 within 2^-20 of the largest entry
(float32 roundings of sums of ~100 terms), bf16 outputs and gradients within
one bf16 rounding (2^-8 of the largest entry; the plain version rounds its
float32 result to bf16 once). The LSE is float32 on both sides.

The launch functions hand the kernel d = 64, 128 or 256 only, zero columns
and the scale of the original d. At d = 32 (pythia-14m,
config/train_inter_scale.yaml) and d = 160 the port's `flash_attention` is
held against the JAX `flash_attention` in interpret mode (which pads D to a
multiple of 128 lanes itself, 256 at d = 160) within 1e-5 in float32;
d = 300 raises.
"""
import importlib

import numpy as np
import pytest
import torch

from slamkit_tpu_torch.ops import mha_reference, mha_reference_bwd

# the module (`slamkit_tpu_torch.ops.flash_attention` is also its function)
port_fa = importlib.import_module("slamkit_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

F32_REL = 2.0 ** -20


def _inputs(d, dtype, seed=0, b=2, h=4, hkv=2, t=96):
    rng = np.random.default_rng(seed + d)
    mk = lambda hh: torch.from_numpy(rng.standard_normal((b, hh, t, d)).astype(np.float32)
                                     ).to(dtype)
    seg = np.zeros((b, t), np.int32)
    for r in range(b):                       # 3 packed segments and a -1 tail
        cuts = np.sort(rng.choice(np.arange(8, t - 8), 2, replace=False))
        seg[r, cuts[0]:] = 1
        seg[r, cuts[1]:] = 2
        seg[r, t - int(rng.integers(1, 8)):] = -1
    return mk(h), mk(hkv), mk(hkv), mk(h), torch.from_numpy(seg)


def _close(got, want, dtype, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    rel = F32_REL if dtype == torch.float32 else 2.0 ** -8
    tol = rel * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (what, err, tol)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernel calls replaced by the plain versions on what they receive;
    returns the list of (direction, tensors received, scale) per call."""
    seen = []

    def kernel(q, k, v, q_seg, k_seg, causal, sm_scale, defines=()):
        seen.append(("fwd", (q, k, v), sm_scale))
        return mha_reference(q, k, v, segment_ids=q_seg, causal=causal, sm_scale=sm_scale,
                             kv_segment_ids=k_seg)

    def kernel_bwd(q, k, v, out, lse, do, q_seg, k_seg, causal, sm_scale, defines=()):
        seen.append(("bwd", (q, k, v, out, do), sm_scale))
        assert lse.shape == q.shape[:3]
        return mha_reference_bwd(q, k, v, q_seg, k_seg, out, lse, do, causal=causal,
                                 sm_scale=sm_scale)

    monkeypatch.setattr(port_fa, "_launch_kernel", kernel)
    monkeypatch.setattr(port_fa, "_launch_bwd_kernel", kernel_bwd)
    return seen


@pytest.mark.parametrize("d", [32, 80, 96, 160, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_plain_equals_unpadded(plain_kernels, d, dtype, causal):
    q, k, v, do, seg = _inputs(d, dtype)
    scale = d ** -0.5
    out, lse = port_fa._launch(q, k, v, seg, seg, causal, scale)
    ref, ref_lse = mha_reference(q, k, v, segment_ids=seg, causal=causal, sm_scale=scale)
    assert out.is_contiguous()
    _close(out, ref, dtype, "out")
    _close(lse, ref_lse, torch.float32, "lse")
    grads = port_fa._launch_bwd(q, k, v, ref, ref_lse, do, seg, seg, causal, scale)
    want = mha_reference_bwd(q, k, v, seg, None, ref, ref_lse, do, causal=causal,
                             sm_scale=scale)
    assert [s[0] for s in plain_kernels] == ["fwd", "bwd"]
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.is_contiguous(), name
        _close(g, w, dtype, name)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernel_head_dims_pass_through_unpadded(plain_kernels, d):
    """At the kernels' own head dims the kernel gets the caller's tensors
    themselves, and its results come back as they are."""
    q, k, v, do, seg = _inputs(d, torch.float32)
    out, lse = port_fa._launch(q, k, v, seg, seg, True, d ** -0.5)
    port_fa._launch_bwd(q, k, v, out, lse, do, seg, seg, True, d ** -0.5)
    (_, fwd_in, _), (_, bwd_in, _) = plain_kernels
    assert all(a is b for a, b in zip(fwd_in, (q, k, v)))
    assert all(a is b for a, b in zip(bwd_in, (q, k, v, out, do)))


@pytest.mark.parametrize("d", [32, 80, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launches_hand_the_kernel_its_head_dim(plain_kernels, d, dtype):
    """`_launch` / `_launch_bwd` hand the kernel contiguous tensors of d = 64,
    128 or 256 whose first d columns are the caller's and the rest zero, and
    the original d's scale."""
    q, k, v, do, seg = _inputs(d, dtype, seed=3)
    scale = d ** -0.5
    out, lse = port_fa._launch(q, k, v, seg, seg, True, scale)
    port_fa._launch_bwd(q, k, v, out, lse, do, seg, seg, True, scale)
    kd = port_fa.kernel_head_dim(d)
    assert kd == (64 if d <= 64 else 128 if d <= 128 else 256)
    (_, fwd_in, fwd_scale), (_, bwd_in, bwd_scale) = plain_kernels
    assert fwd_scale == bwd_scale == scale
    for got, orig in zip((*fwd_in, *bwd_in), (q, k, v, q, k, v, out, do)):
        assert got.shape == (*orig.shape[:-1], kd) and got.is_contiguous()
        assert got.dtype == orig.dtype
        assert torch.equal(got[..., :d], orig) and not got[..., d:].any()


def test_head_dim_above_256_raises(plain_kernels):
    q, k, v, do, seg = _inputs(300, torch.float32)
    with pytest.raises(ValueError, match="up to 256.*ROADMAP queue 3"):
        port_fa.kernel_head_dim(300)
    with pytest.raises(ValueError, match="up to 256"):
        port_fa._launch(q, k, v, seg, seg, True, 300 ** -0.5)
    with pytest.raises(ValueError, match="up to 256"):
        port_fa._launch_bwd(q, k, v, q, torch.zeros(q.shape[:3]), do, seg, seg, True,
                            300 ** -0.5)
    assert plain_kernels == []                   # refused before any kernel call


@pytest.mark.parametrize("causal", [True, False])
def test_d32_matches_the_jax_flash_attention(causal):
    """pythia-14m's heads (4 of 32): the port's `flash_attention` (and its
    gradients through `FlashAttentionFunction`) against the JAX
    `flash_attention` in interpret mode on the same float32 inputs."""
    _match_jax_flash_attention(32, causal, hkv=4)


@pytest.mark.parametrize("causal", [True, False])
def test_d160_matches_the_jax_flash_attention(causal):
    """A head dim both packages pad to 256 (G = 2): the same comparison."""
    _match_jax_flash_attention(160, causal, hkv=2)


def _match_jax_flash_attention(d, causal, hkv):
    import jax
    import jax.numpy as jnp

    from slamkit_tpu.ops import flash_attention as jax_flash_attention

    q, k, v, do, seg = _inputs(d, torch.float32, seed=7, b=2, h=4, hkv=hkv, t=128)
    seg = seg if causal else seg.clamp(min=0)
    want = jax_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               segment_ids=jnp.asarray(seg.numpy()), causal=causal,
                               interpret=True)
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    got = port_fa.flash_attention(qt, kt, vt, segment_ids=seg, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)

    def loss(q_, k_, v_):
        o = jax_flash_attention(q_, k_, v_, segment_ids=jnp.asarray(seg.numpy()),
                                causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(do.numpy()))

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    (got * do).sum().backward()
    for name, g, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)
