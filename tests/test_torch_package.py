"""PyTorch port, package hygiene: the port imports nothing of JAX and nothing
of the reference package; its entry points raise when asked for a card that
is absent instead of carrying on on the CPU; a CPU call through a kernel
wrapper takes the plain version and launches nothing."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _port_files():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_neither_jax_nor_reference():
    modules = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        modules.append(".".join(parts))
    code = (
        "import importlib, sys\n"
        f"mods = {modules!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    from repro_torch.core.program import Program
    from repro_torch.launch import serve as launcher
    from repro_torch.models.registry import build_model, reduced_config
    from repro_torch.nn.module import init_params
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.launch.weave import default_weave

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Program.from_arch("yi-6b", kind="serve", reduced=True)  # default: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(build_model(reduced_config("yi-6b")), 0)
    program = Program.from_arch("yi-6b", kind="serve", reduced=True, device="cpu")
    woven = default_weave(program, "prefill_32k", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(woven, ServerConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--requests", "1"])


def test_cpu_calls_launch_no_kernel():
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    before = (rmsnorm.launches, flash_attention.launches, flash_decode.launches)
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 4, 2, 64)), dtype=torch.float32)
    kv = torch.tensor(rng.standard_normal((1, 16, 1, 64)), dtype=torch.float32)
    assert rmsnorm(q, torch.ones(64)).shape == q.shape
    assert flash_attention(q, kv[:, :4], kv[:, :4]).shape == q.shape
    assert flash_decode(q[:, :1], kv, kv, torch.tensor([7], dtype=torch.int32)).shape == (1, 1, 2, 64)
    assert (rmsnorm.launches, flash_attention.launches, flash_decode.launches) == before


def test_kernel_bindings_refuse_cpu_tensors():
    """The bindings never run a CPU tensor through a plain version: only the
    wrappers choose, and only by where the tensor lies."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd

    x = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_fwd(x, torch.ones(64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_fwd(x, x, x, torch.zeros(1, dtype=torch.int32))


def test_cpu_recurrent_calls_launch_no_kernel():
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rwkv6.ops import wkv

    before = (rglru.launches, wkv.launches)
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(0, 1, (1, 5, 8)), dtype=torch.float32)
    y, h = rglru(a, a, torch.zeros(1, 8))
    assert y.shape == (1, 5, 8) and h.shape == (1, 8)
    x = torch.tensor(rng.standard_normal((1, 5, 2, 64)), dtype=torch.float32)
    y, s = wkv(x, x, x, torch.sigmoid(x), torch.zeros(2, 64), torch.zeros(1, 2, 64, 64))
    assert y.shape == x.shape and s.shape == (1, 2, 64, 64)
    assert (rglru.launches, wkv.launches) == before


def test_recurrent_kernel_bindings_refuse_cpu_tensors():
    from repro_torch.kernels.rglru.kernel import rglru_fwd
    from repro_torch.kernels.rwkv6.kernel import wkv_fwd

    a = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_fwd(a, a, torch.zeros(1, 8))
    x = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_fwd(x, x, x, x, torch.zeros(2, 64), torch.zeros(1, 2, 64, 64))


def test_build_is_keyed_by_source_hash_and_ignored_by_git():
    from repro_torch.kernels import build

    assert [p.name for p in build.sources()] == ["flash_decode.cu", "flash_prefill.cu",
                                                 "rglru.cu", "rmsnorm.cu", "wkv6.cu"]
    assert len(build.source_hash()) == 16
    assert build.build_dir() == ROOT / "build" / "repro_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert set(build.SIGNATURES) == {"repro_torch_rmsnorm", "repro_torch_flash_prefill",
                                     "repro_torch_flash_decode", "repro_torch_rglru",
                                     "repro_torch_wkv6"}


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """Runs only where there is a card (`python3 chip_smoke.py` holds the
    kernels against their plain versions at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    x = torch.randn(8, 4096, device="cuda", dtype=torch.bfloat16)
    w = torch.rand(4096, device="cuda")
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_ref(x, w), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_reduced_head_dim_launches_the_kernels_on_the_card():
    """Woven to `"cuda"` on the card, attention launches its kernels at the
    launchers' reduced head_dim 16 as well: nothing gives way to the plain
    attention there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
    from repro_torch.launch.serve import build_server
    from repro_torch.runtime.server import ServerConfig

    server = build_server("yi-6b", reduced=True, device="cuda",
                          cfg=ServerConfig(max_cache_len=32, decode_tokens=4))
    cfg = server.woven.program.cfg
    assert cfg.head_dim == 16
    before = (flash_attention.launches, flash_decode.launches)
    out = server.serve(np.ones((2, 8), np.int32))
    assert out.shape == (2, 4)
    assert flash_attention.launches - before[0] == cfg.num_layers
    assert flash_decode.launches - before[1] == cfg.num_layers * 4


@pytest.mark.gpu
def test_recurrent_kernels_match_plain_versions_on_the_card():
    """K5 and K6 against their plain versions, ragged lengths and a nonzero
    initial state (`python3 chip_smoke.py` holds them at the main path's
    shapes); K5 repeats the plain version's roundings exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.ref import rglru_scan
    from repro_torch.kernels.rwkv6.ops import wkv
    from repro_torch.kernels.rwkv6.ref import wkv_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    a = torch.rand((2, 37, 300), generator=gen, device="cuda")
    b = torch.randn((2, 37, 300), generator=gen, device="cuda")
    h0 = torch.randn((2, 300), generator=gen, device="cuda")
    before = rglru.launches
    for got, want in zip(rglru(a, b, h0), rglru_scan(a, b, h0)):
        assert torch.equal(got, want)
    assert rglru.launches == before + 1
    r, k, v = (torch.randn((2, 45, 3, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((2, 45, 3, 64), generator=gen, device="cuda")))
    u = torch.randn((3, 64), generator=gen, device="cuda")
    s0 = torch.randn((2, 3, 64, 64), generator=gen, device="cuda")
    y, s_last = wkv(r, k, v, w, u, s0)
    y_ref, s_ref = wkv_scan(r, k, v, w, u, s0)
    scale = y_ref.float().abs().max().item() + 1.0
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=5e-3, atol=5e-3 * scale)
    torch.testing.assert_close(s_last, s_ref, rtol=5e-3, atol=5e-3)
