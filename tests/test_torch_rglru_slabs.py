"""PyTorch port, K5 (the RG-LRU scan) at the odd shapes its slab walk masks.

The CUDA kernel (`src/repro_torch/csrc/rglru.cu`) walks slabs of channels
through a ring of time tiles, masking a ragged last slab and a ragged time
tail, and must give the plain scan's bits.  Here, on the CPU:

- the port's plain `rglru_scan` against the reference's `rglru_scan` and its
  Pallas kernel in interpret mode (within 1e-4, as
  `test_torch_recurrent.py` holds them), and against a numpy walk with the
  kernel's two roundings a step bit for bit, at one step, ragged lengths and
  widths that are no multiple of the slab (or of 4);
- the wrapper on a CPU tensor takes the plain version and counts no launch;
- the variants tool's edits find the kernel's compiled-in constants in the
  shipped source and in the tool's bulk-feed source, and the ring those
  constants give fits one block's shared memory.

The `gpu`-marked test holds the kernel itself to the plain scan bit for bit
at the same odd shapes; it skips where there is no card."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru_pallas
from repro.kernels.rglru.ref import rglru_scan as j_rglru_scan
from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_scan

from _torch_port import t, to_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "rglru.cu"
SMEM_LIMIT = 232448  # shared memory one block may opt into on an H100

# (B, S, D): one step; a ragged tail past one and two 64-step tiles; widths
# short of a 16- or 32-channel slab, past it by a few, and no multiple of 4
SHAPES = [(1, 1, 40), (2, 1, 7), (1, 65, 40), (2, 130, 20), (3, 37, 36), (1, 257, 72),
          (2, 17, 1001)]


def _inputs(B, S, D, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D))))).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0


def _numpy_walk(a, b, h0):
    """h = a_t * h, rounded, + b_t, rounded: the kernel's step, in float32."""
    h = h0.copy()
    y = np.empty_like(b)
    for i in range(a.shape[1]):
        h = (a[:, i] * h).astype(np.float32) + b[:, i]
        y[:, i] = h
    return y, h


@pytest.mark.parametrize("B,S,D", SHAPES)
def test_plain_scan_matches_reference_at_odd_shapes(B, S, D):
    a, b, h0 = _inputs(B, S, D, seed=S * D + B)
    y, h_last = rglru_scan(t(a), t(b), t(h0))
    assert y.shape == (B, S, D) and h_last.shape == (B, D)
    ja, jb, jh = (jnp.asarray(v) for v in (a, b, h0))
    want = [j_rglru_scan(ja, jb, jh),
            rglru_pallas(ja, jb, jh, interpret=True),
            rglru_pallas(ja, jb, jh, block_d=8, chunk=16, interpret=True)]
    for wy, wh in want:
        np.testing.assert_allclose(to_np(y), np.asarray(wy), atol=1e-4, rtol=0)
        np.testing.assert_allclose(to_np(h_last), np.asarray(wh), atol=1e-4, rtol=0)
    ny, nh = _numpy_walk(a, b, h0)
    assert np.array_equal(to_np(y), ny) and np.array_equal(to_np(h_last), nh)


def test_cpu_tensor_takes_the_plain_scan_and_counts_no_launch(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return rglru_scan(*args)

    monkeypatch.setattr(lru_ops, "rglru_scan", spy)
    a, b, h0 = (t(x) for x in _inputs(2, 37, 1001, seed=3))
    before = rglru.launches
    y, h_last = rglru(a, b, h0)
    assert rglru.launches == before
    assert calls == [a.shape]
    want = rglru_scan(a, b, h0)
    assert torch.equal(y, want[0]) and torch.equal(h_last, want[1])


def _variants_tool():
    spec = importlib.util.spec_from_file_location(
        "rglru_variants", ROOT / "tools" / "rglru_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_variants_tool_edits_the_shipped_constants():
    tool = _variants_tool()
    text = SOURCE.read_text()
    shipped = {"slab": _constant(text, "kLruSlab"), "tile": _constant(text, "kLruTile"),
               "stages": _constant(text, "kLruStages")}
    assert shipped == tool.SHIPPED
    assert {**shipped, "feed": "cp_async"} in tool.variants().values()
    for name, src_dir in tool.FEEDS.values():
        feed_text = (Path(src_dir) / name).read_text()
        for old, _ in tool.edits(tool.SHIPPED):
            assert feed_text.count(old) == 1, (name, old)



def _ring_bytes(text):
    """`kLruSmemBytes` as the source defines it, from the source's constants."""
    assert ("kLruSmemBytes = kLruStages * kLruStageBytes + 3 * kLruStages * sizeof(uint64_t)"
            in text)
    assert "kLruStageBytes = 2 * kLruTileFloats * sizeof(float)" in text
    assert "kLruTileFloats = kLruTile * kLruSlab" in text
    stages, tile, slab = (_constant(text, n) for n in ("kLruStages", "kLruTile", "kLruSlab"))
    return stages * (2 * tile * slab * 4) + 3 * stages * 8


def test_every_ring_fits_one_block():
    text = SOURCE.read_text()
    assert _ring_bytes(text) <= SMEM_LIMIT
    assert _constant(text, "kLruSlab") * 4 % 16 == 0  # a tile row is whole 16-byte copies
    tool = _variants_tool()
    bulk = Path(tool.FEEDS["bulk"][1]) / tool.FEEDS["bulk"][0]
    for v in tool.variants().values():
        edited = text
        for old, new in tool.edits(v):
            edited = edited.replace(old, new)
        assert _ring_bytes(edited) == tool.smem_bytes(v["slab"], v["tile"], v["stages"])
        assert _ring_bytes(edited) <= SMEM_LIMIT
    assert _ring_bytes(bulk.read_text()) == _ring_bytes(text)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D", [(1, 1, 2560), (1, 257, 2568), (3, 33, 1001),
                                   (2, 130, 20), (1, 2048, 2560)])
def test_kernel_is_the_plain_scan_bit_for_bit_on_the_card(B, S, D):
    """One launch a call; y and h_last equal the plain scan's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    a, b, h0 = (t(x).cuda() for x in _inputs(B, S, D, seed=S + D))
    before = rglru.launches
    y, h_last = rglru(a, b, h0)
    torch.cuda.synchronize()
    assert rglru.launches == before + 1
    want = rglru_scan(a, b, h0)
    assert torch.equal(y, want[0]) and torch.equal(h_last, want[1])
