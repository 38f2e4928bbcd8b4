"""Build and load the hand-written CUDA kernels.

The sources under `repro_torch/csrc/` are compiled with `nvcc` for `sm_90a`
— one compiler process per source file, all started together — and linked
into one shared library with a plain C interface, loaded through `ctypes`.
The build happens at the first launch of any kernel, never at import, and
goes into `build/repro_torch/` at the root of the checkout.  The library's
file name carries a hash of the sources and flags, so a stale build is never loaded.
A failed build raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PTR, _INT, _FLOAT, _I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                            ctypes.c_longlong)
# C signatures of the entry points (every pointer and the stream are void*)
SIGNATURES = {
    "repro_torch_rmsnorm": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _FLOAT, _PTR],
    "repro_torch_flash_prefill": (
        [_PTR] * 5 + [_INT] * 8 + [_I64] * 12
        + [_INT, _INT, _FLOAT, _FLOAT, _INT, _INT, _INT, _PTR]),
    "repro_torch_flash_bwd": (
        [_PTR] * 10 + [_INT] * 7 + [_I64] * 21
        + [_INT, _INT, _FLOAT, _FLOAT, _INT, _INT, _INT, _INT, _PTR]),
    "repro_torch_flash_decode": (
        [_PTR] * 8 + [_INT] * 10 + [_I64] * 15
        + [_INT, _INT, _FLOAT, _FLOAT, _INT, _INT, _PTR]),
    "repro_torch_rglru": [_PTR] * 5 + [_INT] * 3 + [_PTR],
    "repro_torch_wkv6": [_PTR] * 8 + [_INT] * 4 + [_PTR],
}


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):  # .cu and .cuh
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile (if this exact source set was not built yet) and return the
    library's path and the seconds the build took (0.0 on a cache hit)."""
    out_dir = build_dir()
    lib_path = out_dir / f"librepro_torch_kernels_{source_hash()}.so"
    if lib_path.exists():
        return lib_path, 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{lib_path.stem}.{os.getpid()}"
    procs = []
    for src in sources():
        obj = out_dir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / f"{lib_path.stem}.log").write_text("\n".join(log))
    objs = [str(obj) for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)[-8000:])
        tmp = out_dir / f"{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build loses nothing
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return lib_path, time.perf_counter() - t0


def build_log() -> str:
    """What nvcc / ptxas printed for the current sources ("" if not built)."""
    path = build_dir() / f"librepro_torch_kernels_{source_hash()}.log"
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {code}")


def dtype_code(dtype) -> int:
    """The C entry points' code of a value type (q, o, and unquantized K/V)."""
    import torch

    if dtype == torch.bfloat16:
        return 0
    if dtype == torch.float32:
        return 1
    raise TypeError(f"the CUDA kernels take bfloat16 and float32, not {dtype}")


def kv_dtype_code(dtype) -> int:
    """The code of a K/V element type: a value type, or the int8 / fp8 codes
    of a quantized cache (2 = int8, 3 = float8_e4m3fn, 4 = float8_e5m2)."""
    import torch

    codes = {torch.int8: 2, getattr(torch, "float8_e4m3fn", None): 3,
             getattr(torch, "float8_e5m2", None): 4}
    if dtype in codes:
        return codes[dtype]
    return dtype_code(dtype)


def check_operand(name: str, t, vec: int) -> None:
    """The addressing the kernels rely on: unit stride in the last dim, every
    other stride and the base address a multiple of one vector load — 16
    bytes for values, 8 for the one-byte codes of a quantized cache."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous, "
                         f"strides {t.stride()}")
    align = vec * t.element_size()
    if any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % align:
        raise ValueError(f"{name}: strides {t.stride()} / base address are not "
                         f"{align}-byte aligned")


def refuse_grad(what: str, *tensors) -> None:
    """The forward-only kernels (RMSNorm, RG-LRU, WKV) have no backward, as
    in the reference, whose Pallas calls have no VJP: asked for a result
    that autograd would have to differentiate, a wrapper raises instead of
    returning one cut off from the graph (whose gradients would be missing
    without a word).  Training takes the plain PyTorch path for these ops."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel is forward-only (the reference has no "
            "backward for it either); run it under torch.no_grad(), or weave "
            "the plain implementation where gradients are needed")
