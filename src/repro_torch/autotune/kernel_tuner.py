"""DSE-driven kernel autotuning on the card — closing the paper's Fig. 13–14
loop.

The Lat DSE (paper §4.1) explores the knobs of a kernel's launch, the
results become a mARGOt `KnowledgeBase` (paper §2.5), and the best operating
point persists in an on-disk cache keyed by the kernel's problem signature.
Entry points (`repro_torch.kernels.flash_attention.ops`) and the weaver
(`TunedKernelAspect`) consult the cache, so woven programs and the serving
runtime pick tuned knobs automatically.

Layout of the cache file (JSON), the reference's:

    {"<signature key>[@cuda]": {"knobs": {...best...},
                                "metrics": {"latency_s": [mean, std], ...},
                                "ops": [{"knobs": ..., "metrics": ...}, ...],
                                "device": "cuda" | "cpu"}}

Rows measured on the card are keyed `<signature key>@cuda`, and a lookup on
a CUDA tensor reads only those; a tuner for `device="cpu"` keys the bare
signature, as the reference's interpret-mode rows are keyed, so either
package reads the other's bare rows.

**The spaces are the card's.**  A knob belongs to a space only if it
changes the launch the signature makes (`design_space`), and that depends
on the signature's dtype, which picks the route:

- `flash_attention`: bf16 runs the tensor-core forward and backward, whose
  tiles are compiled in (`kernel.TC_BLOCK_*`: any requested block maps to
  them, `kernel.route_blocks`), so the reference's `block_q` / `block_kv` /
  `block_q_bwd` / `block_kv_bwd` change nothing there.  Its knob is
  `dkv_n_split`, the number of blocks K3's dk / dv pass splits a KV head's
  group across (a divisor of the group; without a row,
  `kernel.dkv_n_split`'s heuristic picks it).  fp32 runs the FMA route,
  whose blocks are the requested ones up to `kernel.MAX_BLOCK_*`: `block_q`,
  `block_kv`, `block_q_bwd` in (16, 32, 64), `block_kv_bwd` in (16, 32).
- `flash_decode` (one token over a dense cache): bf16 takes the split route,
  whose chunk is fixed (`decode.SPLIT_CHUNK`: a request's bits must not
  depend on its batch or its paging), so it has no knob; fp32 takes the FMA
  body and tunes `block_kv_dec` in (16, 32, 64).
- `paged_decode`: `page_size` in (64, 128, 256, 512), up to the cache, the
  pool's geometry (its HBM model is `prefix_shared_pool_bytes`); fp32 adds
  `block_kv_dec`.
- `quantized_cache`: `cache_dtype` in ("float16", "int8",
  "float8_e4m3fn") — the reference's arms, "float16" meaning "keep the
  unquantized pool" — times `page_size`; fp32 adds `block_kv_dec`.
- `speculative`: `draft_len` in (1, 2, 4, 8), below the cache length, which
  sets the verify step's widened q; fp32 adds `block_kv_dec`.
- `rwkv6` (the reference's `chunk`), `rglru` (`block_d`, `chunk`) and
  `rmsnorm` (`block_rows`): none.  K6 runs 32-step chunks and its kernel
  refuses any other (`kernels/rwkv6/kernel.py`), K5's slab and tile are
  compiled in (`kernels/rglru/kernel.py`), and K4 takes no block size.

A space with no knob is not tunable: `tune` raises a `ValueError` naming the
fixed tile, and a lookup there always misses.

The constraint of every point is `smem_bytes`, the dynamic shared memory one
block of the launch requests (`config_smem_bytes`, from the constants of the
`.cu` sources), against `DEFAULT_SMEM_BUDGET`, an H100 block's opt-in limit.

Tuning is always explicit (launch tooling, `chip_smoke.py`, tests) and on
the card: the default measure times the kernels there and refuses the CPU.
Lookups on the hot path are dict reads, memoised per (call, device) until
the cache is next written, and never measure.  The one sanctioned implicit write path is
`refine_from_runtime`: serving traffic's observed latencies (mARGOt error
coefficients) rescale the cached operating points and re-select the knobs
under the adjusted constraints.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import uuid
from typing import Any, Callable, Mapping

from repro_torch.autotune.dse import Lat
from repro_torch.autotune.margot import LE, Goal, KnowledgeBase, Margot, OperatingPoint, State
from repro_torch.kernels.flash_attention.decode import (
    SPLIT_CHUNK,
    SPLIT_ROWS,
    SPLIT_WARPS,
)
from repro_torch.kernels.flash_attention.kernel import (
    MAX_BLOCK_KV,
    MAX_BLOCK_Q,
    TC_BLOCK_KV,
    TC_BLOCK_KV_BWD,
    TC_BLOCK_Q,
    TC_BLOCK_Q_BWD,
    cdiv,
)

# shared memory one block may opt into on an H100 (sm_90: 227 KB)
DEFAULT_SMEM_BUDGET = 227 * 1024

_DTYPE_BYTES = {
    "float32": 4, "f32": 4, "bfloat16": 2, "bf16": 2, "float16": 2,
    "int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
}
# the quantized-pool arms the DSE explores ("float16": keep the fp pool)
CACHE_DTYPES = ("float16", "int8", "float8_e4m3fn")
_CODE_DTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")

PAGE_SIZES = (64, 128, 256, 512)
DRAFT_LENS = (1, 2, 4, 8)
# the FMA route's blocks: powers of two up to its tile capacity
# (kernel.MAX_BLOCK_Q / MAX_BLOCK_KV / MAX_BLOCK_Q_BWD 64, MAX_BLOCK_KV_BWD 32)
FMA_BLOCKS = (16, 32, 64)
FMA_BLOCKS_KV_BWD = (16, 32)

# what fixes the launch of a space with no knob on the card
FIXED_TILES = {
    "flash_decode": f"decode.SPLIT_CHUNK = {SPLIT_CHUNK} (the split route's chunk)",
    "rwkv6": "the 32-step chunk of csrc/wkv6.cu (kernels/rwkv6/kernel.py)",
    "rglru": "the slab and tile of csrc/rglru.cu (kernels/rglru/kernel.py)",
    "rmsnorm": "csrc/rmsnorm.cu, which takes no block size",
}


def dtype_name(dtype: Any) -> str:
    """A dtype's name as the reference spells it: "bfloat16" for
    `torch.bfloat16`, a jnp dtype or the string itself."""
    name = getattr(dtype, "name", None) or str(dtype)
    return name.removeprefix("torch.")


def dtype_bytes(dtype: Any) -> int:
    return _DTYPE_BYTES.get(dtype_name(dtype), 4)


# ---------------------------------------------------------------------------
# Signatures (keys equal to the reference's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSignature:
    """Everything that changes which launch configuration is optimal."""

    kernel: str               # flash_attention | flash_decode | paged_decode | ...
    shape: tuple[int, ...]    # problem shape (kernel-specific, see helpers)
    dtype: str = "bfloat16"
    causal: bool = False
    window: int | None = None
    gqa: int = 1              # q heads per kv head

    def key(self) -> str:
        shp = "x".join(str(s) for s in self.shape)
        mask = "c" if self.causal else "f"
        win = str(self.window) if self.window is not None else "-"
        return f"{self.kernel}/{shp}/{self.dtype}/{mask}/w{win}/g{self.gqa}"


def flash_signature(q_shape, kv_heads: int, dtype, *, causal: bool,
                    window: int | None = None) -> KernelSignature:
    """q_shape is the model layout (B, S, H, D)."""
    B, S, H, D = q_shape
    return KernelSignature(
        kernel="flash_attention", shape=(B, S, H, kv_heads, D),
        dtype=dtype_name(dtype), causal=causal, window=window,
        gqa=H // max(kv_heads, 1),
    )


def _decode_family(kernel: str, batch: int, cache_len: int, n_heads: int,
                   kv_heads: int, head_dim: int, dtype, window) -> KernelSignature:
    return KernelSignature(
        kernel=kernel, shape=(batch, cache_len, n_heads, kv_heads, head_dim),
        dtype=dtype_name(dtype), causal=True, window=window,
        gqa=n_heads // max(kv_heads, 1),
    )


def flash_decode_signature(batch: int, cache_len: int, n_heads: int,
                           kv_heads: int, head_dim: int, dtype="bfloat16",
                           *, window: int | None = None) -> KernelSignature:
    """One-token decode against a dense length-`cache_len` cache."""
    return _decode_family("flash_decode", batch, cache_len, n_heads, kv_heads,
                          head_dim, dtype, window)


def paged_decode_signature(batch: int, cache_len: int, n_heads: int,
                           kv_heads: int, head_dim: int, dtype="bfloat16",
                           *, window: int | None = None) -> KernelSignature:
    """Block-table decode against a shared page pool: the pool's geometry
    (`page_size`) is its knob."""
    return _decode_family("paged_decode", batch, cache_len, n_heads, kv_heads,
                          head_dim, dtype, window)


def quantized_cache_signature(batch: int, cache_len: int, n_heads: int,
                              kv_heads: int, head_dim: int, dtype="bfloat16",
                              *, window: int | None = None) -> KernelSignature:
    """The accuracy-constrained dtype x geometry DSE of the quantized pool:
    `dtype` keys the fp *reference* pool; `cache_dtype` is a knob whose fp
    name is the accuracy-fallback arm (keep the fp pool)."""
    return _decode_family("quantized_cache", batch, cache_len, n_heads, kv_heads,
                          head_dim, dtype, window)


def speculative_signature(batch: int, cache_len: int, n_heads: int,
                          kv_heads: int, head_dim: int, dtype="bfloat16",
                          *, window: int | None = None) -> KernelSignature:
    """The speculative verify step: K2's widened q at `draft_len + 1`
    tokens a request; the useful tokens a step scale with the acceptance,
    which serving feeds back as `tokens_per_step`."""
    return _decode_family("speculative", batch, cache_len, n_heads, kv_heads,
                          head_dim, dtype, window)


def rmsnorm_signature(rows: int, dim: int, dtype="bfloat16") -> KernelSignature:
    """Fused RMSNorm problem: (rows, d) with rows = batch * seq."""
    return KernelSignature(kernel="rmsnorm", shape=(rows, dim), dtype=dtype_name(dtype))


def rwkv6_signature(batch: int, seq_len: int, d_model: int,
                    head_dim: int = 64, dtype="float32") -> KernelSignature:
    """WKV problem signature: (B, S, H, C) with H = d_model // head_dim."""
    return KernelSignature(
        kernel="rwkv6",
        shape=(batch, seq_len, d_model // max(head_dim, 1), head_dim),
        dtype=dtype_name(dtype),
    )


def rglru_signature(batch: int, seq_len: int, width: int,
                    dtype="float32") -> KernelSignature:
    """RG-LRU problem signature: (B, S, D) with D the lru width."""
    return KernelSignature(kernel="rglru", shape=(batch, seq_len, width),
                           dtype=dtype_name(dtype))


# ---------------------------------------------------------------------------
# Design spaces + the shared-memory constraint
# ---------------------------------------------------------------------------


def tensor_core_route(sig: KernelSignature) -> bool:
    """Whether the signature's launches take the tensor-core routes (bf16),
    rather than the FMA bodies (every other dtype)."""
    return sig.dtype in ("bfloat16", "bf16")


def space_values(sig: KernelSignature) -> dict[str, tuple]:
    """Every value of every knob that changes the signature's launch on the
    card, before the shape's own limits (`design_space` applies those);
    empty where the launch is fixed in the source."""
    tc = tensor_core_route(sig)
    blk = {} if tc else {"block_kv_dec": FMA_BLOCKS}
    if sig.kernel == "flash_attention":
        if tc:
            G = max(sig.gqa, 1)
            return {"dkv_n_split": tuple(n for n in range(1, G + 1) if G % n == 0)}
        return {"block_q": FMA_BLOCKS, "block_kv": FMA_BLOCKS,
                "block_q_bwd": FMA_BLOCKS, "block_kv_bwd": FMA_BLOCKS_KV_BWD}
    if sig.kernel == "flash_decode":
        return blk
    if sig.kernel == "paged_decode":
        return {"page_size": PAGE_SIZES, **blk}
    if sig.kernel == "quantized_cache":
        return {"cache_dtype": CACHE_DTYPES, "page_size": PAGE_SIZES, **blk}
    if sig.kernel == "speculative":
        return {"draft_len": DRAFT_LENS, **blk}
    if sig.kernel in FIXED_TILES:
        return {}
    raise KeyError(sig.kernel)


def tunable(sig: KernelSignature) -> bool:
    return bool(space_values(sig))


def _pad_dim(D: int) -> int:
    """The head dim the tensor-core kernels are instantiated at."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _fma_attend_smem(rows: int, D: int) -> int:
    """`attend_smem_bytes<RT>` of csrc/attend_core.cuh: q, k, v tiles padded
    by one float, the score tile, m / l / alpha and lo / hi of RT rows over
    its 64-row KV capacity."""
    floats = (rows + 2 * MAX_BLOCK_KV) * (D + 1) + rows * (MAX_BLOCK_KV + 1) + 3 * rows
    return floats * 4 + 2 * rows * 4


def _fma_bwd_smem(D: int) -> int:
    """The larger of `dq_smem_bytes` and `dkv_smem_bytes` (csrc/flash_bwd.cu:
    pass 1 64 q rows over 32-row KV tiles, pass 2 32 KV rows over 64-row q
    tiles)."""
    dq = (2 * 64 * (D + 1) + 2 * 32 * (D + 1) + 64 * (32 + 1) + 2 * 64) * 4
    dkv = (2 * 32 * (D + 1) + 2 * 64 * (D + 1) + 2 * 32 * (64 + 1) + 2 * 64) * 4
    return max(dq, dkv)


def _tc_smem(D: int, codes: bool = False) -> int:
    """`TcShape<DP>::smem` / `smem_codes` (csrc/attend_tc.cuh): the q tile and
    two (K, V) stages, or over codes one bf16 (K, V) and two code stages."""
    DP = _pad_dim(D)
    if not codes:
        return (TC_BLOCK_Q + 4 * TC_BLOCK_KV) * DP * 2
    stage = 2 * TC_BLOCK_KV * DP + 2 * TC_BLOCK_KV * 4
    return (TC_BLOCK_Q + 2 * TC_BLOCK_KV) * DP * 2 + 2 * stage


def _tc_bwd_smem(D: int) -> int:
    """The larger of `TcDqShape<DP>::smem` and `TcDkvShape<DP>::smem`
    (csrc/flash_bwd.cu); the split reduce takes none."""
    DP = _pad_dim(D)
    dq = (2 * TC_BLOCK_Q_BWD + 4 * TC_BLOCK_KV_BWD) * DP * 2 + 2 * TC_BLOCK_Q_BWD * 4
    dkv = (2 * TC_BLOCK_KV_BWD + 4 * TC_BLOCK_Q_BWD) * DP * 2 + 4 * TC_BLOCK_Q_BWD * 4
    return max(dq, dkv)


def _split_smem(D: int, codes: bool) -> int:
    """`SplitShape<DP, CODES>::smem` (csrc/decode_split.cuh): the q rows and
    each warp's two-stage ring (plus, over codes, their scales and the bf16
    K / V a step is widened into)."""
    DP = _pad_dim(D)
    bt = max(2048 // DP, 16)  # slots of a step (kSplitStep / DP)
    tile = bt * DP
    stage = (2 if codes else 4) * tile
    scales = 2 * bt * 4 if codes else 0
    warp = 2 * (stage + scales) + (4 * tile if codes else 0)
    return SPLIT_ROWS * DP * 2 + SPLIT_WARPS * warp


# rows of one FMA block (csrc/flash_prefill.cu kPrefillRT, flash_decode.cu kDecodeRT)
_FMA_PREFILL_ROWS = MAX_BLOCK_Q
_FMA_DECODE_ROWS = 16


def config_smem_bytes(sig: KernelSignature, knobs: Mapping[str, Any]) -> int:
    """Dynamic shared memory one block of the point's launches requests (the
    LE constraint): the largest over the launches the signature makes."""
    D = sig.shape[-1]
    tc = tensor_core_route(sig)
    if sig.kernel == "flash_attention":
        # forward + fused backward; the blocks of the FMA route change the
        # grid, not the tiles' capacity, and dkv_n_split the grid alone
        if tc:
            return max(_tc_smem(D), _tc_bwd_smem(D))
        return max(_fma_attend_smem(_FMA_PREFILL_ROWS, D), _fma_bwd_smem(D))
    if sig.kernel in ("flash_decode", "paged_decode"):
        return _split_smem(D, False) if tc else _fma_attend_smem(_FMA_DECODE_ROWS, D)
    if sig.kernel == "quantized_cache":
        codes = str(knobs["cache_dtype"]) in _CODE_DTYPES
        return _split_smem(D, codes) if tc else _fma_attend_smem(_FMA_DECODE_ROWS, D)
    if sig.kernel == "speculative":
        return _tc_smem(D) if tc else _fma_attend_smem(_FMA_DECODE_ROWS, D)
    raise KeyError(f"{sig.kernel}: no knob changes its launch on the card")


def prefix_shared_pool_bytes(sig: KernelSignature, knobs: Mapping[str, Any],
                             *, prefix_len: int | None = None) -> int:
    """HBM a prefix-shared pool allocates for the signature's batch at the
    knob's pool geometry: full prefix pages are stored *once* (refcounted
    copy-on-write sharing in `repro_torch.runtime.pages`), each request adds
    only its suffix pages plus the prefix/suffix straddling partial.
    Sharing rounds the prefix *down* to a page boundary, so smaller pages
    share more of it.  `prefix_len` defaults to half the cache."""
    B, T, H, K, D = sig.shape
    ps = int(knobs["page_size"])
    prefix = min(T // 2 if prefix_len is None else int(prefix_len), T)
    shared_full = prefix // ps           # stored once, every table maps them
    per_request = cdiv(T, ps) - shared_full
    pages = shared_full + B * per_request
    return pages * ps * K * D * 2 * dtype_bytes(sig.dtype)


def quantized_pool_bytes(sig: KernelSignature, knobs: Mapping[str, Any]) -> int:
    """HBM the pool allocates for the signature's batch at the knob's
    dtype x geometry: codes at `cache_dtype` plus the fp32 scale sidecars
    (K and V scales of each page and KV head).  Fp names model the
    unquantized pool (no sidecars).  The denominator of the
    `tokens_per_hbm_byte` objective."""
    B, T, H, K, D = sig.shape
    ps = int(knobs["page_size"])
    qb = _DTYPE_BYTES.get(str(knobs["cache_dtype"]), dtype_bytes(sig.dtype))
    pages = B * cdiv(max(T, 1), ps)
    per_page = 2 * ps * K * D * qb
    if qb == 1:  # quantized formats carry the fp32 scale sidecars
        per_page += 2 * K * 4
    return pages * per_page


def design_space(sig: KernelSignature, *,
                 smem_budget: int = DEFAULT_SMEM_BUDGET) -> dict[str, list]:
    """Per-knob values, each feasible for the signature's shape on its own
    (cross-knob feasibility is the tuner's point-level constraint)."""
    space = {k: list(v) for k, v in space_values(sig).items()}
    T = sig.shape[1]
    if sig.kernel == "flash_attention":
        for name in ("block_q", "block_kv", "block_q_bwd", "block_kv_bwd"):
            if name in space:
                space[name] = [v for v in space[name] if v <= max(T, 16)]
    if "page_size" in space:
        space["page_size"] = [v for v in space["page_size"] if v <= max(T, 64)]
    if "block_kv_dec" in space:
        space["block_kv_dec"] = [v for v in space["block_kv_dec"] if v <= max(T, 16)]
    if "draft_len" in space:
        # the draft block must fit under the request's decode budget slack
        space["draft_len"] = [v for v in space["draft_len"] if v < max(T, 2)]
    # drop single-knob values that can never fit the shared-memory budget
    for name in list(space):
        feasible = []
        for v in space[name]:
            probe = {n: vals[0] for n, vals in space.items()}
            probe[name] = v
            if config_smem_bytes(sig, probe) <= smem_budget:
                feasible.append(v)
        space[name] = feasible or [space[name][0]]
    return space


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------


def default_cache_path() -> str:
    """`REPRO_TORCH_TUNER_CACHE`, else ~/.cache/repro_torch/kernel_tuner.json:
    another file and variable than the reference's, so the two packages'
    rows never mix."""
    path = os.environ.get("REPRO_TORCH_TUNER_CACHE")
    if path is None:  # read on every hot-path lookup: the home dir only if unset
        path = os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                            "kernel_tuner.json")
    return path


class TunerCache:
    """Tiny JSON-backed store: signature key -> best knobs + DSE rows."""

    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()
        self._data: dict[str, dict] | None = None
        self.hits = 0
        self.misses = 0
        # the hot path's answers, per (call, device): cleared on a write
        self.memo: dict[tuple, dict] = {}

    def _load(self) -> dict[str, dict]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except (OSError, ValueError):  # missing or corrupt: ignored
                self._data = {}
            if not isinstance(self._data, dict):  # valid JSON, not a cache
                self._data = {}
        return self._data

    def get(self, key: str) -> dict | None:
        entry = self._load().get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key: str, entry: dict) -> None:
        data = self._load()
        data[key] = entry
        self.memo.clear()
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        # unique tmp per writer: concurrent puts must not interleave bytes
        tmp = f"{self.path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def __len__(self) -> int:
        return len(self._load())


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def _rows(results: list[dict]) -> list[dict]:
    return [{"knobs": r["knobs"],
             "metrics": {m: list(v) for m, v in r["metrics"].items()}}
            for r in results]


def _ops(entry: dict, extra: Callable[[dict], dict] | None = None) -> list[OperatingPoint]:
    ops = []
    for row in entry.get("ops", []):
        metrics = {m: tuple(v) for m, v in row["metrics"].items()}
        if extra is not None:
            metrics.update(extra(row))
        ops.append(OperatingPoint(knobs=dict(row["knobs"]), metrics=metrics))
    return ops


def _plain_knobs(knobs: Mapping[str, Any]) -> dict[str, Any]:
    return {k: (v if isinstance(v, str) else int(v)) for k, v in knobs.items()}


class KernelTuner:
    """Lat DSE over the card's launch knobs, constrained by the shared
    memory a block requests, persisted through a TunerCache.

    `device` is where the rows are measured and whose rows a lookup reads
    by default: "cuda" (the card: keys `<sig>@cuda`) or "cpu" (bare keys;
    only a caller-supplied measure can tune there)."""

    def __init__(self, cache: TunerCache | str | None = None, *,
                 device: str = "cuda", smem_budget: int = DEFAULT_SMEM_BUDGET):
        self.cache = cache if isinstance(cache, TunerCache) else TunerCache(cache)
        if str(device) not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
        self.device = str(device)
        self.smem_budget = smem_budget
        self.tuned = 0  # DSE runs performed

    # -- lookup ----------------------------------------------------------------

    def _key(self, sig: KernelSignature, device: str | None = None) -> str:
        dev = self.device if device is None else str(device)
        return sig.key() if dev == "cpu" else f"{sig.key()}@{dev}"

    def lookup(self, sig: KernelSignature, device: str | None = None) -> dict | None:
        """The stored best knobs, or None; always None where no knob changes
        the signature's launch on the card."""
        if not tunable(sig):
            return None
        entry = self.cache.get(self._key(sig, device))
        # a malformed entry is a miss: a lookup never breaks a kernel call
        knobs = entry.get("knobs") if isinstance(entry, dict) else None
        return dict(knobs) if isinstance(knobs, dict) else None

    def knowledge_base(self, sig: KernelSignature) -> KnowledgeBase | None:
        """Rebuild the mARGOt KnowledgeBase from the cached DSE rows."""
        entry = self.cache.get(self._key(sig))
        return None if entry is None else KnowledgeBase(_ops(entry))

    # -- tuning ----------------------------------------------------------------

    def _check_tunable(self, sig: KernelSignature) -> None:
        if not tunable(sig):
            raise ValueError(
                f"{sig.key()}: no knob changes this launch on the card; it is "
                f"fixed by {FIXED_TILES.get(sig.kernel, 'the source')}")
        if self.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: a tuner for the card measures "
                                   "there (pass device='cpu' and a measure to tune "
                                   "elsewhere)")

    def tune(
        self,
        sig: KernelSignature,
        measure: Callable[..., float] | None = None,
        *,
        sample: int | None = None,
        num_tests: int = 1,
        seed: int = 0,
    ) -> dict[str, Any]:
        """Run the DSE and persist the best knobs and every operating point.

        `measure(**knobs) -> latency_s` defaults to timing the kernels on the
        card (`default_measure`: the median of `num_tests` timed windows, so
        each point is measured once by the DSE)."""
        self._check_tunable(sig)
        lat_tests = num_tests
        if measure is None:
            measure = default_measure(sig, self.device, num_tests=num_tests)
            lat_tests = 1
        space = design_space(sig, smem_budget=self.smem_budget)

        lat = Lat(sig.key()).set_num_tests(lat_tests)
        for name, values in space.items():
            lat.add_var(name, values)
        lat.add_metric("latency_s", measure)
        lat.add_metric("smem_bytes", lambda **knobs: config_smem_bytes(sig, knobs))
        if sig.kernel == "paged_decode":
            # the shared-prefix HBM model: page_size against prefix capacity
            lat.add_metric("pool_hbm_bytes",
                           lambda **knobs: float(prefix_shared_pool_bytes(sig, knobs)))
        if sig.kernel == "speculative":
            # useful tokens per verify step under the acceptance-1 prior;
            # serving's observed mean rescales it (refine_speculative)
            lat.add_metric("tokens_per_step",
                           lambda **knobs: float(int(knobs["draft_len"]) + 1))
        results = lat.tune(sample=sample, seed=seed)

        feasible = [r for r in results
                    if r["metrics"]["smem_bytes"][0] <= self.smem_budget]
        best = min(feasible or results, key=lambda r: r["metrics"]["latency_s"][0])
        self.cache.put(self._key(sig), {
            "knobs": dict(best["knobs"]),
            "metrics": {m: list(v) for m, v in best["metrics"].items()},
            "ops": _rows(results),
            "device": self.device,
        })
        self.tuned += 1
        return dict(best["knobs"])

    def get(self, sig: KernelSignature,
            measure: Callable[..., float] | None = None, **tune_kw) -> dict[str, Any]:
        """Cached best knobs, tuning on first miss."""
        knobs = self.lookup(sig)
        if knobs is not None:
            return knobs
        return self.tune(sig, measure, **tune_kw)


# ---------------------------------------------------------------------------
# Default measurement: the kernels on the card
# ---------------------------------------------------------------------------


def _card_timer(num_tests: int, reps: int):
    """time_s(fn): one warm-up call, then `num_tests` windows of `reps`
    calls captured into a CUDA graph and replayed between two CUDA events
    (a decode launch is shorter than the time Python takes to issue it);
    the median window over `reps`, in seconds."""
    import torch

    def time_s(fn) -> float:
        fn()  # warm-up launch (and any first-use allocation)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        windows = []
        for _ in range(max(num_tests, 1)):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            windows.append(start.elapsed_time(stop) / reps / 1e3)
        del graph
        return statistics.median(windows)

    return time_s


def _torch_dtype(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(name, torch.float32)


def ragged_index(B: int, T: int):
    """The decode measures' per-request positions: ragged over the cache's
    upper half, the last request at its end (T - 1)."""
    return [T - 1 - (b * (T // 2)) // max(B, 1) for b in reversed(range(B))]


def _shuffled_pool(sig: KernelSignature, page_size: int, gen, device):
    """A page pool holding every request's whole cache at `page_size`, with
    block tables shuffled over the pool (as a long-running pool's are):
    (k pool, v pool, tables)."""
    import torch

    B, T, H, K, D = sig.shape
    nb = cdiv(T, page_size)
    dt = _torch_dtype(sig.dtype)
    k = torch.randn((B * nb, page_size, K, D), generator=gen, device=device).to(dt)
    v = torch.randn((B * nb, page_size, K, D), generator=gen, device=device).to(dt)
    perm = torch.randperm(B * nb, generator=gen, device=device)
    return k, v, perm.to(torch.int32).reshape(B, nb).contiguous()


def default_measure(sig: KernelSignature, device: str = "cuda", *,
                    num_tests: int = 3, seed: int = 0) -> Callable[..., float]:
    """measure(**knobs) -> seconds: the signature's launches timed on the
    card, on inputs from a seeded generator there.  Refuses the CPU: a
    time of the plain version says nothing of the kernels."""
    import torch

    if device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the default measure times the kernels on the card; "
                           "a CPU tuner needs a caller-supplied measure")
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    time_s = _card_timer(num_tests, reps=20)
    dt = _torch_dtype(sig.dtype)

    if sig.kernel == "flash_attention":
        B, S, H, K, D = sig.shape
        q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        opts = dict(causal=sig.causal, window=sig.window)
        time_step = _card_timer(num_tests, reps=3)

        def measure(**knobs):
            # a training step's attention: K1 with lse, then the fused
            # backward K3, so the DSE sees the forward and backward knobs
            def step():
                out, lse = ops._forward(
                    q, k, v, softcap=None, block_q=knobs.get("block_q", MAX_BLOCK_Q),
                    block_kv=knobs.get("block_kv", MAX_BLOCK_KV), pruned=True,
                    return_lse=True, **opts)
                ops.flash_attention_bwd(
                    q, k, v, out, lse, do,
                    block_q=knobs.get("block_q_bwd", knobs.get("block_q")),
                    block_kv=knobs.get("block_kv_bwd", knobs.get("block_kv")),
                    n_split=knobs.get("dkv_n_split"), **opts)
            return time_step(step)

        return measure

    if sig.kernel == "flash_decode":
        B, T, H, K, D = sig.shape
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((B, T, K, D), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        index = torch.tensor(ragged_index(B, T), dtype=torch.int32, device="cuda")

        def measure(**knobs):
            return time_s(lambda: ops.flash_decode(
                q, k, v, index, window=sig.window, block_kv=knobs["block_kv_dec"]))

        return measure

    if sig.kernel == "paged_decode":
        B, T, H, K, D = sig.shape
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(dt)
        index = torch.tensor(ragged_index(B, T), dtype=torch.int32, device="cuda")
        pools: dict[int, tuple] = {}

        def measure(**knobs):
            # one token a request over a pool at the knob's geometry
            ps = int(knobs["page_size"])
            if ps not in pools:
                pools.clear()  # one pool resident at a time
                pools[ps] = _shuffled_pool(sig, ps, gen, "cuda")
            pk, pv, tables = pools[ps]
            return time_s(lambda: ops.flash_decode(
                q, pk, pv, index, window=sig.window, tables=tables, kv_len=T,
                block_kv=knobs.get("block_kv_dec")))

        return measure

    if sig.kernel == "speculative":
        B, T, H, K, D = sig.shape
        k, v = (torch.randn((B, T, K, D), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        qs = {}

        def measure(**knobs):
            # one verify step: K2's widened q scores draft_len + 1 tokens a
            # request near the end of the cache
            S = int(knobs["draft_len"]) + 1
            if S not in qs:
                qs[S] = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt),
                         torch.full((B,), T - S, dtype=torch.int32, device="cuda"))
            q, index = qs[S]
            return time_s(lambda: ops.flash_decode(
                q, k, v, index, window=sig.window, block_kv=knobs.get("block_kv_dec")))

        return measure

    if sig.kernel == "quantized_cache":
        return _quantized_cache_measures(sig, gen, time_s)[0]

    raise KeyError(sig.kernel)


def _quantized_cache_measures(sig: KernelSignature, gen=None, time_s=None):
    """(latency, error) measures of the quantized-cache DSE, on the card.

    Both run the paged `flash_decode` over pools packed at the knob's
    geometry.  The error measure is the mARGOt error model's ground truth,
    as the reference's: the worst absolute deviation of the decode output
    over the quantized pool (per-page scales) from the same values served
    unquantized.  Fp arms score 0.0 by construction.  Per-geometry fp pools
    are kept so every dtype arm compares against identical values."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime.pages import quantize_linear_pool

    if gen is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the quantized-cache measures run on the card")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        time_s = _card_timer(3, reps=20)
    B, T, H, K, D = sig.shape
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(_torch_dtype(sig.dtype))
    index = torch.tensor(ragged_index(B, T), dtype=torch.int32, device="cuda")
    fp_pools: dict[int, tuple] = {}

    def fp_pool(ps):
        if ps not in fp_pools:
            fp_pools[ps] = _shuffled_pool(sig, ps, gen, "cuda")
        return fp_pools[ps]

    def call(k, v, tables, blk, scales=None):
        ksc, vsc = scales if scales is not None else (None, None)
        return ops.flash_decode(q, k, v, index, window=sig.window, tables=tables,
                                kv_len=T, block_kv=blk, k_scale=ksc, v_scale=vsc)

    def pool(knobs):
        k, v, tables = fp_pool(int(knobs["page_size"]))
        name = str(knobs["cache_dtype"])
        if name not in _CODE_DTYPES:
            return k, v, tables, None
        qk, qv, ksc, vsc = quantize_linear_pool(k, v, name)
        return qk, qv, tables, (ksc, vsc)

    def latency(**knobs):
        k, v, tables, scales = pool(knobs)
        return time_s(lambda: call(k, v, tables, knobs.get("block_kv_dec"), scales))

    def error(**knobs):
        if str(knobs["cache_dtype"]) not in _CODE_DTYPES:
            return 0.0
        k, v, tables = fp_pool(int(knobs["page_size"]))
        ref = call(k, v, tables, knobs.get("block_kv_dec"))
        qk, qv, tables, scales = pool(knobs)
        out = call(qk, qv, tables, knobs.get("block_kv_dec"), scales)
        return float((out.float() - ref.float()).abs().max())

    return latency, error


# ---------------------------------------------------------------------------
# Process-wide default tuner (hot-path lookups)
# ---------------------------------------------------------------------------

_default_tuner: KernelTuner | None = None
_default_tuner_path: str | None = None


def default_tuner() -> KernelTuner:
    """Singleton over the default cache path, for the card (re-created if
    REPRO_TORCH_TUNER_CACHE changes, so tests and runs can redirect it)."""
    global _default_tuner, _default_tuner_path
    path = default_cache_path()
    if _default_tuner is None or _default_tuner_path != path:
        _default_tuner = KernelTuner(path)
        _default_tuner_path = path
    return _default_tuner


def _hot_lookup(key: tuple, device: str, *sigs: Callable[[], KernelSignature]) -> dict:
    """The hot path's lookup: one dict read per call, keyed by the call's raw
    arguments.  On a memo miss the signatures are built and looked up in
    turn (the first stored row wins); {} when none is."""
    tuner = default_tuner()
    got = tuner.cache.memo.get((key, device))
    if got is None:
        got = next((k for k in (tuner.lookup(make(), device) for make in sigs) if k), {})
        tuner.cache.memo[(key, device)] = got
    return got


def tuned_flash_blocks(q_shape, kv_heads: int, dtype, *, causal: bool,
                       window: int | None = None, device: str = "cuda") -> dict:
    """Hot-path lookup of `ops.flash_attention`: {} when untuned."""
    return _hot_lookup(
        ("flash_attention", tuple(q_shape), kv_heads, dtype, causal, window), device,
        lambda: flash_signature(tuple(q_shape), kv_heads, dtype, causal=causal,
                                window=window))


def tuned_decode_blocks(q_shape, cache_len: int, kv_heads: int, dtype, *,
                        window: int | None = None, device: str = "cuda") -> dict:
    """Hot-path lookup of `ops.flash_decode` over a dense cache: {} when
    untuned.  q_shape is the model layout (B, 1, H, D)."""
    B, _, H, D = q_shape
    return _hot_lookup(
        ("flash_decode", B, cache_len, H, kv_heads, D, dtype, window), device,
        lambda: flash_decode_signature(B, cache_len, H, kv_heads, D, dtype, window=window))


def tuned_paged_blocks(q_shape, cache_len: int, kv_heads: int, dtype, *,
                       window: int | None = None, device: str = "cuda") -> dict:
    """Hot-path lookup of the paged `ops.flash_decode`: {} when untuned.
    Falls back to the dense `flash_decode` entry, as the reference does."""
    B, _, H, D = q_shape
    return _hot_lookup(
        ("paged_decode", B, cache_len, H, kv_heads, D, dtype, window), device,
        lambda: paged_decode_signature(B, cache_len, H, kv_heads, D, dtype, window=window),
        lambda: flash_decode_signature(B, cache_len, H, kv_heads, D, dtype, window=window))


def tuned_speculative_knobs(batch: int, cache_len: int, n_heads: int,
                            kv_heads: int, head_dim: int, dtype, *,
                            window: int | None = None, device: str = "cuda") -> dict:
    """The speculative space's stored knobs ({} when untuned: serving then
    decodes one token at a time)."""
    return _hot_lookup(
        ("speculative", batch, cache_len, n_heads, kv_heads, head_dim, dtype, window),
        device, lambda: speculative_signature(batch, cache_len, n_heads, kv_heads,
                                              head_dim, dtype, window=window))


# ---------------------------------------------------------------------------
# Quantized-cache DSE: multi-objective (capacity under an accuracy goal)
# ---------------------------------------------------------------------------


def tune_quantized_cache(
    sig: KernelSignature,
    *,
    error_budget: float = 0.05,
    tuner: KernelTuner | None = None,
    measure: Callable[..., float] | None = None,
    error_measure: Callable[..., float] | None = None,
    sample: int | None = None,
    num_tests: int = 1,
    seed: int = 0,
) -> dict[str, Any]:
    """Run the quantized-cache DSE and persist the best knobs and all rows.

    Every `cache_dtype x page_size` point (x `block_kv_dec` on the FMA
    route) records the shared-memory and HBM models, a measured decode
    latency and a measured `max_logit_err` against the fp pool; the
    selected point maximizes `tokens_per_hbm_byte` subject to the error
    staying under `error_budget` and the shared memory under the tuner's
    budget.  The entry records `error_budget` so `select_cache_knobs` can
    re-select under another accuracy constraint without re-measuring."""
    tuner = tuner or default_tuner()
    tuner._check_tunable(sig)
    if measure is None or error_measure is None:
        if tuner.device != "cuda":
            raise RuntimeError("the default quantized-cache measures run on the "
                               "card; a CPU tuner needs caller-supplied measures")
        lat_m, err_m = _quantized_cache_measures(sig)
        measure = measure or lat_m
        error_measure = error_measure or err_m
    space = design_space(sig, smem_budget=tuner.smem_budget)
    B, T = sig.shape[0], sig.shape[1]

    lat = Lat(sig.key()).set_num_tests(num_tests)
    for name, values in space.items():
        lat.add_var(name, values)
    lat.add_metric("latency_s", measure)
    lat.add_metric("smem_bytes", lambda **kn: config_smem_bytes(sig, kn))
    lat.add_metric("pool_hbm_bytes", lambda **kn: float(quantized_pool_bytes(sig, kn)))
    lat.add_metric("tokens_per_hbm_byte",
                   lambda **kn: float(B * T) / quantized_pool_bytes(sig, kn))
    lat.add_metric("max_logit_err", error_measure)
    results = lat.tune(sample=sample, seed=seed)

    fits = [r for r in results if r["metrics"]["smem_bytes"][0] <= tuner.smem_budget]
    accurate = [r for r in fits if r["metrics"]["max_logit_err"][0] <= error_budget]
    best = max(accurate or fits or results,
               key=lambda r: r["metrics"]["tokens_per_hbm_byte"][0])
    tuner.cache.put(tuner._key(sig), {
        "knobs": dict(best["knobs"]),
        "metrics": {m: list(v) for m, v in best["metrics"].items()},
        "ops": _rows(results),
        "error_budget": float(error_budget),
        "device": tuner.device,
    })
    tuner.tuned += 1
    return dict(best["knobs"])


def select_cache_knobs(
    sig: KernelSignature,
    *,
    error_budget: float,
    tuner: KernelTuner | None = None,
) -> dict[str, Any] | None:
    """Re-select the quantized-cache knobs from the persisted DSE rows under
    another accuracy constraint, without re-measuring: a mARGOt State
    maximizes `tokens_per_hbm_byte` subject to `max_logit_err <=
    error_budget` and the shared-memory budget.  The re-selected knobs and
    the new budget are persisted.  None when the signature was never
    tuned."""
    tuner = tuner or default_tuner()
    key = tuner._key(sig)
    entry = tuner.cache.get(key)
    if entry is None or not entry.get("ops"):
        return None
    state = State("cache", objective_metric="tokens_per_hbm_byte", maximize=True)
    state.subject_to(Goal("smem", "smem_bytes", LE, float(tuner.smem_budget)))
    state.subject_to(Goal("accuracy", "max_logit_err", LE, float(error_budget)))
    best = Margot(KnowledgeBase(_ops(entry)), [state]).update()
    knobs = _plain_knobs(best.knobs)
    new_entry = dict(entry)
    new_entry["knobs"] = knobs
    new_entry["metrics"] = {m: list(v) for m, v in best.metrics.items()}
    new_entry["error_budget"] = float(error_budget)
    tuner.cache.put(key, new_entry)
    return knobs


# ---------------------------------------------------------------------------
# Runtime feedback: mARGOt observations refine the persisted DSE priors
# ---------------------------------------------------------------------------


def refine_from_runtime(
    sig: KernelSignature,
    observed: Mapping[str, float],
    *,
    tuner: KernelTuner | None = None,
    latency_budget: float | None = None,
    objective_knob: str | None = None,
    device: str | None = None,
) -> dict[str, Any] | None:
    """Fold serving-time observations back into the persisted tuner cache.

    The paper's MAPE-K loop closed over the persistent knowledge base: the
    cached DSE rows become a mARGOt KnowledgeBase, the observed metric on
    the selected operating point gives an error coefficient (observed /
    expected) that rescales every expectation, and the operating point is
    re-selected — maximize the objective knob (by default the space's first
    numeric knob, e.g. `page_size`) subject to the adjusted latency staying
    under `latency_budget` and the shared memory under the tuner's budget.
    The adjusted rows and the re-selected knobs are persisted.

    Returns the re-selected knobs, or None when the signature was never
    tuned (runtime feedback refines priors; it does not create them).
    """
    tuner = tuner or default_tuner()
    key = tuner._key(sig, device)
    entry = tuner.cache.get(key)
    if entry is None or not entry.get("ops"):
        return None
    if objective_knob is None:
        names = list(space_values(sig)) or list(entry["knobs"])
        # a categorical knob (cache_dtype) cannot be maximized
        numeric = [n for n in names if not isinstance(entry["knobs"].get(n, 0), str)]
        objective_knob = (numeric or names)[0]

    obj = f"knob:{objective_knob}"
    ops = _ops(entry, lambda row: {obj: (float(row["knobs"].get(objective_knob, 0)), 0.0)})
    state = State("serve", objective_metric=obj, maximize=True)
    state.subject_to(Goal("smem", "smem_bytes", LE, float(tuner.smem_budget)))
    if latency_budget is not None:
        state.subject_to(Goal("latency", "latency_s", LE, float(latency_budget)))
    margot = Margot(KnowledgeBase(ops), [state])
    current_key = tuple(sorted(entry["knobs"].items()))
    margot.current = next((op for op in ops if op.key() == current_key), ops[0])
    for metric, value in observed.items():
        margot.observe(metric, float(value))
    best = margot.update()

    coefs = dict(margot._error_coef)

    def scaled(metrics):
        return {m: [v[0] * coefs.get(m, 1.0), v[1] * coefs.get(m, 1.0)]
                for m, v in metrics.items() if not m.startswith("knob:")}

    new_entry = dict(entry)  # keep error_budget / device / extra columns
    new_entry.update({
        "knobs": _plain_knobs(best.knobs),
        "metrics": scaled(best.metrics),
        "ops": [{"knobs": dict(row["knobs"]), "metrics": scaled(row["metrics"])}
                for row in entry["ops"]],
        "runtime": {
            "error_coef": coefs,
            "observed": {m: float(v) for m, v in observed.items()},
            "latency_budget": latency_budget,
        },
    })
    tuner.cache.put(key, new_entry)
    return new_entry["knobs"]
