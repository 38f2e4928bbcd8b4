"""PyTorch port, fused attention backward (K3) and K1's `lse`: the plain
versions against the reference's Pallas kernels (interpret mode) on the
reference's own backward cases, `_FlashCore`'s gradients against autograd
through the plain attention, and the transposed schedule oracles against
the reference's.  Inputs come from numpy with a seed; fp32 cases hold
2e-4 (the reference test's own tolerance: the same sums, reordered), the
bf16 case 5e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jkernel
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    flash_attention_bwd_ref,
)

from _torch_port import t, to_np

torch.set_num_threads(1)

# the six cases of tests/test_grid_pruning.py::TestBackwardParity::test_grad_parity
CASES = [
    ("causal", 256, (4, 2), True, None, None, 128, 128),
    ("sliding", 256, (4, 4), True, 64, None, 64, 64),
    ("softcap", 128, (2, 2), True, 64, 30.0, 64, 64),
    ("gqa", 128, (8, 2), True, None, None, 64, 64),
    ("ragged", 320, (4, 2), True, 96, None, 128, 64),
    ("noncausal", 192, (2, 2), False, None, None, 64, 64),
]


def _inputs(seed, B, S, H, K, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(dtype)
    k = rng.standard_normal((B, S, K, D)).astype(dtype)
    v = rng.standard_normal((B, S, K, D)).astype(dtype)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _kernel_layout(x):
    return jnp.swapaxes(jnp.asarray(x), 1, 2)


@pytest.mark.parametrize("name,S,HK,causal,window,softcap,bq,bkv", CASES)
def test_lse_matches_the_reference_kernel(name, S, HK, causal, window, softcap, bq, bkv):
    H, K = HK
    q, k, v, _ = _inputs(1, 2, S, H, K, 64)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want_o, want_lse = jkernel.flash_attention_fwd(
        _kernel_layout(q), _kernel_layout(k), _kernel_layout(v), block_q=bq,
        block_kv=bkv, interpret=True, return_lse=True, **kw)
    got_o, got_lse = attention_ref(t(q), t(k), t(v), return_lse=True, **kw)
    assert got_lse.shape == (2, H, S) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(to_np(got_lse), np.asarray(want_lse), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(got_o), np.asarray(jnp.swapaxes(want_o, 1, 2)),
                               rtol=2e-4, atol=2e-4)


def _reference_bwd(q, k, v, do, *, bq, bkv, **kw):
    """The reference's forward residuals and fused backward (interpret
    mode), in the model layout."""
    qt, kt, vt = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    out, lse = jkernel.flash_attention_fwd(qt, kt, vt, block_q=bq, block_kv=bkv,
                                           interpret=True, return_lse=True, **kw)
    dq, dk, dv = jkernel.flash_attention_bwd(
        qt, kt, vt, out, lse, _kernel_layout(do).astype(qt.dtype), block_q=bq,
        block_kv=bkv, interpret=True, **kw)
    sw = lambda x: np.asarray(jnp.swapaxes(x, 1, 2), np.float32)
    return sw(out), np.asarray(lse), (sw(dq), sw(dk), sw(dv))


@pytest.mark.parametrize("name,S,HK,causal,window,softcap,bq,bkv", CASES)
def test_bwd_ref_matches_the_reference_kernel(name, S, HK, causal, window, softcap,
                                              bq, bkv):
    H, K = HK
    q, k, v, do = _inputs(2, 2, S, H, K, 64)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse, want = _reference_bwd(q, k, v, do, bq=bq, bkv=bkv, **kw)
    got = flash_attention_bwd_ref(t(q), t(k), t(v), t(out), t(lse), t(do), **kw)
    assert got[1].shape == (2, S, K, 64) and got[2].shape == (2, S, K, 64)
    for name_g, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(to_np(a), b, rtol=2e-4, atol=2e-4, err_msg=name_g)


def test_bwd_ref_matches_the_reference_kernel_in_bf16():
    q, k, v, do = _inputs(3, 1, 192, 4, 2, 64)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    q, k, v = bf(q), bf(k), bf(v)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    out, lse = jkernel.flash_attention_fwd(
        _kernel_layout(qj), _kernel_layout(kj), _kernel_layout(vj), block_q=64,
        block_kv=64, interpret=True, return_lse=True)
    want = jkernel.flash_attention_bwd(
        _kernel_layout(qj), _kernel_layout(kj), _kernel_layout(vj), out, lse,
        _kernel_layout(do).astype(jnp.bfloat16), block_q=64, block_kv=64,
        interpret=True)
    out = np.asarray(jnp.swapaxes(out, 1, 2), np.float32)
    got = flash_attention_bwd_ref(
        t(q, torch.bfloat16), t(k, torch.bfloat16), t(v, torch.bfloat16),
        t(out, torch.bfloat16), t(np.asarray(lse)), t(do, torch.bfloat16))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(to_np(a), np.asarray(jnp.swapaxes(b, 1, 2), np.float32),
                                   rtol=5e-2, atol=5e-2)


def _leaf(x, dtype=torch.float32):
    return t(x, dtype).requires_grad_(True)


@pytest.mark.parametrize("name,S,HK,causal,window,softcap,bq,bkv", CASES)
def test_flash_core_gradients_equal_autograd_through_the_plain_attention(
        name, S, HK, causal, window, softcap, bq, bkv):
    H, K = HK
    q, k, v, do = _inputs(4, 1, S, H, K, 32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    qs, ks, vs = _leaf(q), _leaf(k), _leaf(v)
    out = ops.flash_attention(qs, ks, vs, block_q=bq, block_kv=bkv, **kw)
    got = torch.autograd.grad(torch.sum(out * t(do)), (qs, ks, vs))
    qr, kr, vr = _leaf(q), _leaf(k), _leaf(v)
    want = torch.autograd.grad(torch.sum(attention_ref(qr, kr, vr, **kw) * t(do)),
                               (qr, kr, vr))
    for name_g, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4, msg=name_g)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=3, softcap=2.0),
                                dict(causal=False)])
def test_flash_core_passes_gradcheck_in_float64(kw):
    q, k, v, _ = _inputs(5, 1, 6, 4, 2, 8, np.float64)
    args = tuple(_leaf(x, torch.float64) for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_attention(a, b, c, **kw), args, eps=1e-6, atol=1e-6)


def test_backward_blocks_that_differ_from_the_forward_leave_gradients_unchanged(monkeypatch):
    seen = []
    real = ops.flash_attention_bwd

    def spy(*a, **kw):
        seen.append((kw["block_q"], kw["block_kv"]))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention_bwd", spy)
    q, k, v, _ = _inputs(6, 1, 256, 4, 2, 32)

    def grads(bqb, bkvb):
        leaves = [_leaf(x) for x in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=True, window=96, block_q=128,
                                  block_kv=128, block_q_bwd=bqb, block_kv_bwd=bkvb)
        return torch.autograd.grad(torch.sum(out * out), leaves)

    base, other, default = grads(128, 128), grads(64, 256), grads(None, None)
    assert seen == [(128, 128), (64, 256), (128, 128)]  # unset -> the forward's
    for a, b, c in zip(base, other, default):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_backward_never_differentiates_through_the_plain_attention(monkeypatch):
    calls = {"fwd": 0, "fwd_under_grad": 0, "bwd": 0}
    real_fwd, real_bwd = ops.attention_ref, ops.flash_attention_bwd_ref

    def fwd_spy(*a, **kw):
        calls["fwd"] += 1
        calls["fwd_under_grad"] += torch.is_grad_enabled()
        return real_fwd(*a, **kw)

    def bwd_spy(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(ops, "attention_ref", fwd_spy)
    monkeypatch.setattr(ops, "flash_attention_bwd_ref", bwd_spy)
    q, k, v, do = _inputs(7, 1, 40, 4, 1, 16)
    leaves = [_leaf(x) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    assert out.grad_fn is not None and "FlashCore" in type(out.grad_fn).__name__
    dq, dk, dv = torch.autograd.grad(torch.sum(out * t(do)), leaves)
    # one forward, run outside autograd's recording; the backward is the
    # fused formula, not a replay of the plain attention
    assert calls == {"fwd": 1, "fwd_under_grad": 0, "bwd": 1}
    assert dk.shape == dv.shape == (1, 40, 1, 16) and dq.shape == (1, 40, 4, 16)


def test_without_a_gradient_the_forward_keeps_no_lse(monkeypatch):
    seen = []
    real = ops.attention_ref

    def spy(*a, **kw):
        seen.append(kw.get("return_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "attention_ref", spy)
    q, k, v, _ = _inputs(8, 1, 16, 2, 1, 8)
    out = ops.flash_attention(t(q), t(k), t(v))
    with torch.no_grad():
        ops.flash_attention(_leaf(q), _leaf(k), _leaf(v))
    assert seen == [False, False] and out.grad_fn is None


@pytest.mark.parametrize("S,T,bq,bkv,window", [
    (1024, 1024, 128, 128, None),
    (1024, 1024, 128, 128, 256),
    (1024, 1024, 256, 128, 384),
    (896, 896, 128, 256, 128),
    (4096, 4096, 512, 512, 512),
    (1024, 1024, 64, 32, None),   # the CUDA backward's tiles
    (1000, 1000, 64, 32, 512),
])
def test_q_schedule_equals_the_reference(S, T, bq, bkv, window):
    for pruned in (True, False):
        assert tkernel.q_schedule(S, T, bq, bkv, causal=True, window=window,
                                  pruned=pruned) == \
            jkernel.q_schedule(S, T, bq, bkv, causal=True, window=window, pruned=pruned)
    assert tkernel.q_steps_for(S, T, bq, bkv, True, window) == \
        jkernel.q_steps_for(S, T, bq, bkv, True, window)
    assert tkernel.q_steps_for(S, T, bq, bkv, False, None) == \
        jkernel.q_steps_for(S, T, bq, bkv, False, None)


@pytest.mark.gpu
def test_flash_core_launches_the_kernels_on_the_card():
    """Runs only where there is a card (`python3 chip_smoke.py` holds K3 and
    K1's lse against their plain versions at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").requires_grad_(True)
               for s in ((2, 100, 4, 64), (2, 100, 2, 64), (2, 100, 2, 64)))
    do = torch.randn((2, 100, 4, 64), generator=gen, device="cuda")
    before = (ops.flash_attention.lse_launches, ops.flash_attention_bwd.launches)
    out = ops.flash_attention(q, k, v, causal=True, window=40)
    got = torch.autograd.grad(torch.sum(out * do), (q, k, v))
    assert (ops.flash_attention.lse_launches - before[0],
            ops.flash_attention_bwd.launches - before[1]) == (1, 1)
    qc, kc, vc = (x.detach().cpu().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(
        torch.sum(attention_ref(qc, kc, vc, causal=True, window=40) * do.cpu()),
        (qc, kc, vc))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_backward_binding_refuses_cpu_tensors():
    q, k, v, do = (t(x) for x in _inputs(9, 1, 8, 2, 1, 8))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_bwd(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_fwd(q, k, v, return_lse=True)
