"""PyTorch port, K6 in the chunk-parallel form: its plain twin
`wkv_chunk_parallel` (each chunk's state increment, the scan of the states
over chunks, each chunk's output with the 16-step sub-blocks and the decay
factored at their boundaries) against the sequential `wkv_scan`, the
chunked `wkv_chunked` and the reference's Pallas kernel in interpret mode,
at chunks of 32 and 64 steps, ragged lengths, weak and strong decays, decays
that underflow to 0, a nonzero initial state, bf16 and fp32 r / k / v — on
the CPU.  The `gpu`-marked test holds the kernel itself against its twin and
the sequential form on the card (`python3 chip_smoke.py` does so at the main
path's shapes); without a card it skips.  The reference package is imported
inside the tests only, so that the card's run needs no JAX."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6 import kernel as tker
from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.kernels.rwkv6.ref import wkv_chunk_parallel, wkv_chunked, wkv_scan

# fp32 r / k / v: the forms sum in other orders and factor the decays
# differently, and strong decays (exp of up to ~e^9 per step) amplify fp32
# rounding, so the forms part by up to ~2e-5 of the output's scale;
# bf16 r / k / v: y is rounded to bf16 (a step of 2^-8 relative), as the
# reference's own test tolerates (tests/test_kernels.py, TestWKV6)
FP32_TOL, BF16_TOL = 1e-4, 5e-3


def _inputs(B, S, H, C, decay, dtype, seed, underflow=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, C)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(decay * rng.standard_normal((B, S, H, C)))).astype(np.float32)
    if underflow:  # a quarter of the decays are exactly 0: log clamps at 1e-30
        w[rng.random(w.shape) < 0.25] = 0.0
    u = (0.5 * rng.standard_normal((H, C))).astype(np.float32)
    s0 = rng.standard_normal((B, H, C, C)).astype(np.float32)
    t = [torch.tensor(x) for x in (r, k, v, w, u, s0)]
    t[:3] = [x.to(dtype) for x in t[:3]]
    return t


def _close(got, want, tol):
    y, s = got
    y_want, s_want = want
    assert y.dtype == y_want.dtype and s.dtype == torch.float32
    scale = y_want.float().abs().max().item() + 1.0
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    dy = (y.float() - y_want.float()).abs().max().item()
    ds = (s - s_want).abs().max().item()
    assert dy <= tol * scale, f"y off by {dy} at scale {scale}"
    assert ds <= tol * (s_want.abs().max().item() + 1.0), f"state off by {ds}"


CASES = [  # S, chunk, decay, dtype, underflow
    (100, 32, 0.5, torch.float32, False),
    (100, 64, 3.0, torch.float32, False),
    (1000, 32, 3.0, torch.float32, False),
    (1000, 64, 0.5, torch.bfloat16, False),
    (96, 32, 3.0, torch.float32, True),
    (17, 64, 0.5, torch.bfloat16, True),
]


@pytest.mark.parametrize("S,chunk,decay,dtype,underflow", CASES)
def test_twin_matches_the_sequential_and_chunked_forms(S, chunk, decay, dtype, underflow):
    args = _inputs(2, S, 3, 64, decay, dtype, seed=S + chunk, underflow=underflow)
    got = wkv_chunk_parallel(*args, chunk=chunk)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    _close(got, wkv_scan(*args), tol)
    _close(got, wkv_chunked(*args, chunk=chunk), tol)


@pytest.mark.parametrize("S,chunk,decay,dtype,underflow", [
    (100, 32, 3.0, torch.float32, False),
    (200, 64, 0.5, torch.bfloat16, True),
])
def test_twin_matches_the_reference_kernel(S, chunk, decay, dtype, underflow):
    """Against the reference's Pallas WKV in interpret mode (its chunk the
    same as the twin's; a ragged length, padded by the reference's wrapper)."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6.ops import wkv_pallas

    args = _inputs(1, S, 2, 64, decay, dtype, seed=7, underflow=underflow)
    got = wkv_chunk_parallel(*args, chunk=chunk)
    y, s = wkv_pallas(*(jnp.asarray(x.float().numpy()) for x in args), chunk=chunk,
                      interpret=True)
    want = (torch.tensor(np.asarray(y)).to(dtype), torch.tensor(np.asarray(s)))
    _close(got, want, FP32_TOL if dtype == torch.float32 else BF16_TOL)


def test_stable_where_the_decays_overflow_a_chunk_wide_factoring():
    """Decays so strong that exp(-li) over one chunk overflows fp32 (a
    factoring at the chunk's ends would give inf): every exponent the twin
    takes is <= 0, so its output stays finite and equals the sequential
    form."""
    r, k, v, w, u, s0 = _inputs(1, 64, 2, 64, 0.5, torch.float32, seed=3)
    w = torch.full_like(w, 0.05)  # log w = -3 a step: -96 over 32 steps
    assert torch.isinf(torch.exp(-torch.cumsum(torch.log(w[:, :32]), dim=1))).any()
    _close(wkv_chunk_parallel(r, k, v, w, u, s0), wkv_scan(r, k, v, w, u, s0), FP32_TOL)


def test_twin_keeps_the_input_dtype_and_its_chunk_is_the_kernels():
    import inspect
    import re

    from repro_torch.kernels import build

    args = _inputs(1, 9, 2, 64, 0.5, torch.bfloat16, seed=1)
    y, s = wkv_chunk_parallel(*args, chunk=tker.CHUNK)
    assert y.dtype == torch.bfloat16 and y.shape == args[0].shape
    assert s.dtype == torch.float32 and s.shape == args[5].shape
    # the CUDA source compiles one chunk in and refuses another
    src = (build.CSRC / "wkv6.cu").read_text()
    assert re.findall(r"constexpr int kWkvChunk = (\d+);", src) == [str(tker.CHUNK)]
    assert inspect.signature(wkv_chunk_parallel).parameters["chunk"].default == tker.CHUNK
    # the entry point: 10 pointers, then dtype, B, S, H, chunk and the stream
    assert len(build.SIGNATURES["repro_torch_wkv6"]) == 16
    with pytest.raises(ValueError):
        wkv_chunk_parallel(*args, chunk=24)


def test_cpu_tensors_take_the_sequential_form_and_count_nothing():
    args = _inputs(1, 40, 2, 64, 0.5, torch.float32, seed=2)
    before = wkv.launches
    got = wkv(*args)
    assert wkv.launches == before
    want = wkv_scan(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,decay,dtype", [
    (1, 2048, 40, 0.5, torch.bfloat16),
    (2, 1000, 40, 3.0, torch.float32),
    (1, 17, 4, 3.0, torch.bfloat16),
])
def test_kernel_on_the_card(B, S, H, decay, dtype):
    """More than B x H blocks a call; within the reference's tolerance of
    the sequential form, and of the twin at the fp32 gate for fp32 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    args = [x.cuda() for x in _inputs(B, S, H, 64, decay, dtype, seed=S)]
    before = wkv.launches
    got = wkv(*args)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    _close(got, wkv_scan(*args), BF16_TOL)
    if dtype == torch.float32:
        _close(got, wkv_chunk_parallel(*args, chunk=tker.CHUNK), FP32_TOL)
