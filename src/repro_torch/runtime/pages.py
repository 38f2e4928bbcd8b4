"""Paged KV-cache pool: the vLLM block-table layout for the serving runtime.

`stack_request_caches` batches variable-length requests by padding every
per-request cache to the same length — device memory scales with
batch x max_len even when most requests are short.  This module replaces
that with one shared pool of fixed-size pages per layer:

  PagePool            host-side refcounted free-list allocator (pure
                      Python, the reference's own): pages are allocated on
                      admission, appended at the logical tail as a
                      request's cache grows past a page boundary, shared
                      across requests with a common prompt prefix (refcount
                      bumps), split copy-on-write when a holder writes a
                      shared page, and released when the request retires.
                      Admission is reservation-aware, so decode can never
                      deadlock on pages.

  PagedCacheManager   owner of the per-layer page pools on the device.  It
                      admits requests by prefilling straight into pool pages
                      (the paged-prefill path through Attention), maps a new
                      request's common prompt prefix onto existing pages
                      through a token-hash prefix index, re-forms the
                      batched decode cache for the requests active *this
                      step* (continuous batching), splits shared pages
                      copy-on-write before the step that would write them,
                      and absorbs the step's per-request state back.

The pools are updated **in place**: a paged prefill or decode step writes
into the pool tensors it is handed, and a copy-on-write split copies one
page inside the pool tensor (the reference donates the buffers to the same
effect).  So the pools never change identity; `prefill_view`,
`absorb_prefill` and `admit_finish` keep the reference's signatures, and
their rebinding of the step's outputs is a rebinding to the same tensors.

The cache a step consumes holds per layer group `{"pk", "pv"}` pools of
shape (P, page_size, K, D) (leading layer dim under a scanned stack), the
fp32 `{"ksc", "vsc"}` (P, K) scale sidecars of an int8 / fp8 pool, a
per-request `index`, and one shared top-level `block_tables` (B,
num_blocks) that the `flash_decode` kernel resolves per block.  Prefix
sharing is invisible to the kernel: two table rows naming one physical page
stream the same bytes an unshared layout holds, so paged output equals it
bit for bit.

A speculative verify step writes a whole draft block; `rollback` trims the
rejected tail by refcount alone (no page copy).  `PoolAuditor` /
`audit_pool` check the pool's invariants at the resilience layer's
barriers.
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.kernels.flash_attention.kernel import cdiv
from repro_torch.kernels.flash_attention.ops import (
    kv_scale_from_absmax,
    quantize_kv_write,
    resolve_cache_dtype,
)


def _copy_pool_page(pool, src: int, dst: int) -> None:
    """pool[..., dst, :, :, :] = pool[..., src, :, :, :], in place — the
    device half of a copy-on-write split.  The page axis is always -4
    ((P, ps, K, D), or (n, P, ps, K, D) under a scanned stack): one page's
    bytes are written, never a copy of the pool."""
    pool[..., dst, :, :, :] = pool[..., src, :, :, :]


def _copy_scale_row(scales, src: int, dst: int) -> None:
    """Scale-sidecar half of a copy-on-write split, in place: the new
    private page keeps the donor page's quantization scales, so its
    already-written slots dequantize to the same values.  Page axis -2."""
    scales[..., dst, :] = scales[..., src, :]


def _zero_scale_rows(scales, pages: torch.Tensor) -> None:
    """Pop freed pages' scale rows back to the 0.0 free-page sentinel, in
    place, so a later re-allocation sees a fresh page (first write records
    its scale)."""
    scales[..., pages, :] = 0.0


def _live_positions(width: int, length: int, device) -> torch.Tensor:
    """(width,) slot -> position map of a linear cache holding `length`
    tokens: slot s holds position s while live, -1 beyond."""
    ar = torch.arange(width, dtype=torch.int32, device=device)
    return torch.where(ar < length, ar, torch.full_like(ar, -1))


class PoolExhausted(RuntimeError):
    """Raised when an alloc/grow asks for more pages than the free list holds."""


# ---------------------------------------------------------------------------
# Host-side allocator
# ---------------------------------------------------------------------------


class PagePool:
    """Refcounted free-list page allocator with per-request block tables.

    Pure host-side bookkeeping: physical page ids are ints in
    [0, num_pages); a request's block table maps logical page i (cache
    slots [i*page_size, (i+1)*page_size)) to its physical page.  The free
    list is LIFO so released pages are reused first — the pool's working
    set stays compact under admit/retire churn.

    Pages carry refcounts so several tables may map the same physical page
    (prefix sharing).  `alloc` bumps the shared prefix instead of drawing
    from the free list, `release` decrements and frees only pages whose
    count hits zero, and `cow` performs the copy-on-write *remap* half of
    a split (the device-side page copy is the manager's job).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(f"bad pool geometry ({num_pages=}, {page_size=})")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._refs: list[int] = [0] * num_pages
        self.tables: dict[Any, list[int]] = {}
        self.peak_live = 0    # max distinct pages ever allocated at once
        self.peak_mapped = 0  # max table entries (counting shares) at once

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Distinct physical pages in use (shared pages count once)."""
        return self.num_pages - len(self._free)

    @property
    def mapped_pages(self) -> int:
        """Total table entries — what an unshared pool would have to hold."""
        return sum(len(t) for t in self.tables.values())

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def pages_for(self, length: int) -> int:
        """Pages needed to back `length` cache slots."""
        return cdiv(max(int(length), 0), self.page_size)

    def _bump_peaks(self) -> None:
        self.peak_live = max(self.peak_live, self.live_pages)
        self.peak_mapped = max(self.peak_mapped, self.mapped_pages)

    def alloc(self, rid, n_pages: int, *,
              shared: Sequence[int] = ()) -> list[int]:
        """Allocate a table of `n_pages` pages: the `shared` prefix maps
        existing live pages (refcount bump — no free pages consumed), the
        remainder comes fresh off the free list."""
        if rid in self.tables:
            raise KeyError(f"request {rid!r} already holds pages")
        shared = list(shared)
        if len(shared) > n_pages:
            raise ValueError(
                f"shared prefix ({len(shared)}) exceeds table ({n_pages})")
        for p in shared:
            if not (0 <= p < self.num_pages) or self._refs[p] <= 0:
                raise ValueError(f"page {p} is not live — stale prefix share")
        need = n_pages - len(shared)
        if need > len(self._free):
            raise PoolExhausted(
                f"need {need} pages, {len(self._free)} free")
        for p in shared:
            self._refs[p] += 1
        fresh = [self._free.pop() for _ in range(need)]
        for p in fresh:
            self._refs[p] = 1
        self.tables[rid] = shared + fresh
        self._bump_peaks()
        return list(self.tables[rid])

    def grow_to(self, rid, n_pages: int) -> list[int]:
        """Contiguous-tail growth: append pages until the table covers
        n_pages logical pages.  Returns the newly appended physical ids."""
        table = self.tables[rid]
        need = n_pages - len(table)
        if need <= 0:
            return []
        if need > len(self._free):
            raise PoolExhausted(
                f"grow {rid!r} needs {need} pages, {len(self._free)} free")
        new = [self._free.pop() for _ in range(need)]
        for p in new:
            self._refs[p] = 1
        table.extend(new)
        self._bump_peaks()
        return new

    def release(self, rid) -> list[int]:
        """Drop the request's references; returns the pages actually freed
        (refcount hit zero) — shared pages stay live for their co-owners."""
        pages = self.tables.pop(rid)
        freed = []
        # reversed: LIFO reuse hands back the request's pages tail-first
        for p in reversed(pages):
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def truncate(self, rid, n_pages: int) -> list[int]:
        """Misprediction rollback: drop the request's table entries beyond
        `n_pages`, tail-first.  Each released page is an O(1) refcount
        decrement — pages hitting zero return to the free list, shared
        (donor) pages just lose this request's reference and their bytes
        are never touched or copied.  Returns the pages actually freed."""
        if n_pages < 0:
            raise ValueError(f"cannot truncate to {n_pages} pages")
        table = self.tables[rid]
        freed = []
        while len(table) > n_pages:
            p = table.pop()
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def cow(self, rid, logical: int) -> tuple[int, int] | None:
        """Copy-on-write remap: if the request's `logical` table entry is
        shared (refcount > 1), take a fresh page, point the table at it and
        drop one reference on the original.  Returns (old, new) physical
        ids for the caller to copy device-side, or None when the page was
        already exclusive."""
        table = self.tables[rid]
        old = table[logical]
        if self._refs[old] <= 1:
            return None
        if not self._free:
            raise PoolExhausted(
                f"copy-on-write split for {rid!r} needs a free page")
        new = self._free.pop()
        self._refs[new] = 1
        self._refs[old] -= 1
        table[logical] = new
        self._bump_peaks()
        return old, new

    def table_rows(self, rids: Iterable[Any], width: int) -> np.ndarray:
        """(B, width) int32 block tables, unallocated tail entries 0 (a
        valid page id: dead blocks may DMA it, never enter the math)."""
        rids = list(rids)
        rows = np.zeros((len(rids), width), np.int32)
        for i, rid in enumerate(rids):
            table = self.tables[rid]
            if len(table) > width:
                raise ValueError(
                    f"table of {rid!r} ({len(table)}) exceeds width {width}")
            rows[i, : len(table)] = table
        return rows


# ---------------------------------------------------------------------------
# Device-side paged cache manager
# ---------------------------------------------------------------------------


def _is_kv_group(value: Any) -> bool:
    return isinstance(value, dict) and "k" in value and "v" in value \
        and "ck" not in value


def paged_compatible(cache: dict) -> bool:
    """True when every stateful leaf group of a per-request decode cache is
    an attention KV cache — the families the paged pool can host.  SSM /
    recurrent states (rwkv, rglru) and cross-attention caches keep the
    dense stacked layout (`stack_request_caches`)."""
    if not isinstance(cache, dict):
        return False
    seen_kv = False
    for name, value in cache.items():
        if name == "kv_pos" or value is None:
            continue
        if not _is_kv_group(value):
            return False
        seen_kv = True
    return seen_kv


def _prefix_digests(toks: np.ndarray, page_size: int):
    """(per-boundary digests, whole-prompt digest) of a token sequence —
    the prefix-index key material.  One incremental blake2b fed page by
    page (each boundary digest covers tokens[0 : (i+1)*page_size], the
    tail digest the whole prompt), so hashing a prompt is O(S) bytes, not
    O(S^2 / page_size)."""
    data = np.ascontiguousarray(toks, np.int64).tobytes()
    stride = page_size * 8  # int64 token bytes per page
    h = hashlib.blake2b(digest_size=16)
    bounds = []
    for i in range(len(toks) // page_size):
        h.update(data[i * stride: (i + 1) * stride])
        bounds.append(h.copy().digest())
    h.update(data[len(bounds) * stride:])
    return bounds, h.digest()


class PagedCacheManager:
    """Owns the per-layer page pools + per-request paged cache state.

    One manager serves one `Server.serve_continuous` call (or a test's
    hand-driven decode loop).  Two admission paths exist:

      * the legacy `admit` packs an already-built per-request prefill
        cache into freshly allocated pages (kept for tests and callers
        with dense caches in hand);
      * the direct-to-pool path — `init_structure` (from a 1-token probe
        cache) then `match_prefix` / `admit_begin` / `admit_finish` (or
        `admit_shared` + `rescore_view` on a full-prompt prefix hit) —
        lets the model's paged-prefill branch scatter K/V straight into
        pool pages, so admission never materializes a dense max_len cache.

    `batch` re-forms the decode cache for the currently active requests
    (growing tail pages for the token about to be written and splitting
    shared pages copy-on-write first), `absorb` stores the post-step state
    back, and `retire` returns the request's references to the pool.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 max_len: int | None = None, window: int | None = None,
                 prefix_sharing: bool = True,
                 cache_dtype: str | None = None):
        self.pool = PagePool(num_pages, page_size)
        self.page_size = page_size
        self.max_len = max_len          # logical linear-cache capacity
        self.window = window            # model's sliding/local window
        self.prefix_sharing = prefix_sharing
        # quantized pool storage ("int8" / "float8_*"): pk/pv at the narrow
        # dtype plus fp32 per-page-per-head scale sidecars.  Unknown / fp
        # names resolve to None — the pool stays at the model dtype.
        self.cache_dtype = resolve_cache_dtype(cache_dtype)
        self._pools: dict[str, dict[str, torch.Tensor]] = {}
        self._groups: dict[str, dict[str, Any]] = {}  # structure, 1st admit
        self._meta: dict[Any, dict[str, Any]] = {}    # per-request state
        # prefix index: token-prefix digest (per page boundary) -> physical
        # page.  "full" keys freeze at page boundaries and never go stale
        # while the page lives (decode writes land strictly past every
        # registered prefix); "tail" keys map a whole prompt's straddling
        # partial page — valid because sharers mask slots >= their own
        # length, and any write into the page splits it copy-on-write.
        self._prefix_index: dict[tuple, int] = {}
        self._page_keys: dict[int, list[tuple]] = {}
        # one-entry match memo: can_admit and the admission that follows
        # probe the same prompt back to back — invalidated whenever the
        # index mutates (_register_prefix / _purge_keys)
        self._match_cache: tuple[bytes, list[int], int] | None = None
        self.prefix_hits = 0  # pages mapped shared at admission
        self.cow_splits = 0   # copy-on-write page splits performed

    # -- admission -------------------------------------------------------------

    @property
    def has_structure(self) -> bool:
        return bool(self._groups)

    def _slots_needed(self, length: int, *,
                      prompt_len: int | None = None) -> int:
        """Worst-case pages to back `length` slots across all groups (ring
        groups clamp to their window — the slot space wraps there).  Before
        the structure is known, clamp by the configured capacity — and by
        the window when `prompt_len` says the request will ring — so
        admission control works on the very first request too."""
        if self._groups:
            return max(
                self.pool.pages_for(min(length, info["length"]))
                for info in self._groups.values()
            )
        if self.max_len is not None:
            length = min(length, self.max_len)
        if (self.window is not None and prompt_len is not None
                and prompt_len > self.window):
            length = min(length, self.window)
        return self.pool.pages_for(length)

    def _linear_len(self) -> int | None:
        lens = [info["length"] for info in self._groups.values()
                if not info["ring"]]
        return max(lens) if lens else None

    def _ring_pool(self) -> bool:
        return any(info["ring"] for info in self._groups.values())

    def _cow_exposure(self, rid) -> int:
        """Shared pages this request may still have to split: table entries
        with refcount > 1 inside its remaining write range."""
        if not self.prefix_sharing or self._ring_pool():
            return 0
        m = self._meta[rid]
        table = self.pool.tables.get(rid)
        if table is None:
            return 0
        lo = m["length"] // self.page_size
        hi = min(self._slots_needed(m["final_len"]), len(table))
        return sum(1 for i in range(lo, hi)
                   if self.pool.refcount(table[i]) > 1)

    def can_admit(self, final_len: int, tokens=None) -> bool:
        """Admission control: free pages must cover this request's worst
        case — *new* pages only: a matched prompt prefix rides on shared
        pages, plus one page if its shared tail may need a copy-on-write
        split — plus every active request's outstanding growth and
        copy-on-write exposure, so decode never hits PoolExhausted
        mid-flight.  Works before the first admission too: the structure-
        free path derives slots-per-token from the configured capacity
        (and the window, when the prompt rings)."""
        prompt_len = (len(np.asarray(tokens).reshape(-1))
                      if tokens is not None else None)
        need = self._slots_needed(final_len, prompt_len=prompt_len)
        if tokens is not None and self._groups:
            pages, shared_len = self.match_prefix(tokens)
            need -= len(pages)
            if shared_len and (shared_len % self.page_size
                               or shared_len >= prompt_len):
                # a shared tail page may split copy-on-write later — and a
                # full-prompt hit may be trimmed back to a suffix prefill
                # (long prompts; see Server._paged_admit), costing one
                # fresh page the share would otherwise have covered
                need += 1
        reserved = sum(
            self._slots_needed(m["final_len"]) - len(self.pool.tables[rid])
            + self._cow_exposure(rid)
            for rid, m in self._meta.items()
        )
        return self.pool.free_pages - reserved >= need

    def _scan_structure(self, cache: dict, *, ring: bool | None = None,
                        length: int | None = None) -> None:
        if not paged_compatible(cache):
            raise ValueError(
                "cache has non-KV state groups; paged serving supports "
                "attention-cache models — use Server.serve_batch")
        for name, value in cache.items():
            if name == "kv_pos" or value is None:
                continue
            k = value["k"]
            scanned = k.ndim == 5  # (n, 1, T, K, D) under a scanned stack
            is_ring = ("pos" in value) if ring is None else ring
            self._groups[name] = {
                "scanned": scanned,
                "n": k.shape[0] if scanned else None,
                "ring": is_ring,
                # W (ring) or max_len (linear); an explicit override wins —
                # the probe path scans a 1-token cache whose shapes say
                # nothing about capacity
                "length": length if length is not None else k.shape[-3],
                "kv_heads": k.shape[-2],
                "head_dim": k.shape[-1],
                "dtype": k.dtype,
                "device": k.device,
            }

    def init_structure(self, probe_cache: dict, *, ring: bool = False) -> None:
        """Learn the pool structure (groups, dtypes, head shapes) from a
        1-token probe prefill cache and build the page pools — the
        direct-to-pool admission path's replacement for scanning a full
        dense prefill.  `ring` declares the cache family the *first real
        request* will pack (prompt longer than the window rings)."""
        if self._groups:
            raise RuntimeError("pool structure already initialised")
        if self.max_len is None:
            raise ValueError("init_structure needs the manager's max_len")
        if ring and self.window is None:
            raise ValueError("ring structure needs the manager's window")
        length = min(self.window, self.max_len) if ring else self.max_len
        self._scan_structure(probe_cache, ring=ring, length=length)
        self._ensure_pools(self.pool.num_pages)

    def _quant_dtype(self, info):
        """Pool storage dtype override for a group, or None to stay fp.
        Ring groups never quantize: the wrap rewrites page-interior slots,
        which breaks the fixed first-write page-scale policy."""
        if self.cache_dtype is None or info["ring"]:
            return None
        return self.cache_dtype

    def _ensure_pools(self, num_pages: int) -> None:
        ps = self.page_size
        for name, info in self._groups.items():
            if name in self._pools:
                continue
            qdt = self._quant_dtype(info)
            shape = (num_pages, ps, info["kv_heads"], info["head_dim"])
            sshape = (num_pages, info["kv_heads"])
            if info["scanned"]:
                shape = (info["n"], *shape)
                sshape = (info["n"], *sshape)
            dev = info["device"]
            pools = {
                "pk": torch.zeros(shape, dtype=qdt or info["dtype"], device=dev),
                "pv": torch.zeros(shape, dtype=qdt or info["dtype"], device=dev),
            }
            if qdt is not None:
                # fp32 per-page-per-head dequant scales; 0.0 = free page
                pools["ksc"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
                pools["vsc"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
            self._pools[name] = pools

    @property
    def table_width(self) -> int:
        ps = self.page_size
        return max(cdiv(info["length"], ps) for info in self._groups.values())

    # -- prefix sharing ---------------------------------------------------------

    def match_prefix(self, tokens) -> tuple[list[int], int]:
        """Longest registered prefix of `tokens` already resident in the
        pool: ([physical pages], shared slot count).  Full pages chain at
        page boundaries; a whole-prompt match may extend onto the donor's
        partial tail page (shared_len == len(tokens) — the rescore path).
        Ring pools never share (slot contents depend on the wrap)."""
        if not self.prefix_sharing or not self._groups or self._ring_pool():
            return [], 0
        toks = np.asarray(tokens, np.int64).reshape(-1)
        S = len(toks)
        lin = self._linear_len()
        if lin is None or S > lin:
            return [], 0
        key = toks.tobytes()
        if self._match_cache is not None and self._match_cache[0] == key:
            return list(self._match_cache[1]), self._match_cache[2]
        ps = self.page_size
        bounds, whole = _prefix_digests(toks, ps)
        pages: list[int] = []
        for i, digest in enumerate(bounds):
            page = self._prefix_index.get(("full", i, digest))
            if page is None:
                break
            pages.append(page)
        shared_len = len(pages) * ps
        if len(pages) == len(bounds) and S % ps:
            page = self._prefix_index.get(("tail", S, whole))
            if page is not None:
                pages.append(page)
                shared_len = S
        self._match_cache = (key, list(pages), shared_len)
        return pages, shared_len

    def _register_prefix(self, rid, tokens) -> None:
        if not self.prefix_sharing or self._ring_pool():
            return
        toks = np.asarray(tokens, np.int64).reshape(-1)
        S = len(toks)
        table = self.pool.tables[rid]
        ps = self.page_size
        self._match_cache = None

        def put(key, page):
            if key in self._prefix_index:
                return
            self._prefix_index[key] = page
            self._page_keys.setdefault(page, []).append(key)

        bounds, whole = _prefix_digests(toks, ps)
        for i in range(min(len(bounds), len(table))):
            put(("full", i, bounds[i]), table[i])
        if S % ps and S // ps < len(table):
            put(("tail", S, whole), table[S // ps])

    def _purge_keys(self, pages: Iterable[int]) -> None:
        for page in pages:
            keys = self._page_keys.pop(page, ())
            if keys:
                self._match_cache = None
            for key in keys:
                if self._prefix_index.get(key) == page:
                    del self._prefix_index[key]

    # -- direct-to-pool admission ------------------------------------------------

    def _check_family(self, prompt_len: int) -> None:
        ring_req = self.window is not None and self.window < prompt_len
        if ring_req != self._ring_pool():
            raise ValueError(
                f"request cache family mismatch (ring={ring_req}, "
                f"len={prompt_len}) vs the pool's "
                f"(ring={self._ring_pool()}); sliding-window serving needs "
                "prompts on one side of the window — use serve_batch "
                "otherwise")

    def _new_meta(self, rid, prompt_len: int, final_len: int) -> None:
        meta: dict[str, Any] = {
            "length": int(prompt_len),
            "final_len": int(final_len),
            "pos": {},
        }
        lin = self._linear_len()
        if lin is not None:
            meta["kv_pos"] = _live_positions(lin, prompt_len, self._device())
        self._meta[rid] = meta

    def _device(self) -> torch.device:
        return next(iter(self._groups.values()))["device"]

    def _table_row(self, rid) -> torch.Tensor:
        return self._upload(self.pool.table_rows([rid], self.table_width))

    def _upload(self, rows: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of host-built int32 rows (block tables,
        per-request indices)."""
        return torch.from_numpy(rows).to(self._device())

    def admit_begin(self, rid, tokens, *, final_len: int,
                    shared_pages: Sequence[int] = (),
                    shared_len: int = 0):
        """Allocate the block table (shared prompt prefix + fresh pages)
        and return the paged *prefill* cache view the model scatters the
        non-shared suffix into, plus the static prefix length.

        `final_len` is the most cache slots this request will ever occupy
        (prompt + decode budget), reserved for deadlock-free growth.
        """
        if not self._groups:
            raise RuntimeError("init_structure (or admit) must run first")
        toks = np.asarray(tokens, np.int64).reshape(-1)
        S = len(toks)
        self._check_family(S)
        start = shared_len
        if start >= S:
            raise ValueError("full-prompt prefix hits go through admit_shared")
        if start and (shared_len % self.page_size
                      or len(shared_pages) * self.page_size != shared_len):
            raise ValueError("partial shared prefixes must be page-aligned")
        lin = self._linear_len()
        if not self._ring_pool() and lin is not None and S > lin:
            raise ValueError(
                f"prompt ({S} tokens) exceeds the pool's linear capacity "
                f"({lin}) — raise max_cache_len")
        table = self.pool.alloc(rid, self._slots_needed(S),
                                shared=shared_pages)
        self.prefix_hits += len(shared_pages)
        self._new_meta(rid, S, final_len)
        return self.prefill_view(rid, start), start

    def prefill_view(self, rid, resident: int) -> dict:
        """Single-request paged *prefill* cache view with ``index`` pinned
        at `resident` tokens already pool-written — the view `admit_begin`
        hands a fresh admission (resident = shared prefix length) and the
        chunked-prefill loop re-requests between chunks (resident = last
        chunk boundary).  Chunk boundaries must stay page-aligned: a
        quantized page's scale is fixed by its first write, so every page
        must be written by exactly one prefill dispatch for the pool bytes
        to match a one-shot prefill bit-for-bit.
        """
        view: dict[str, Any] = {}
        for name, info in self._groups.items():
            group: dict[str, Any] = dict(self._pools[name])
            idx = np.full((1,), resident, np.int32)
            if info["scanned"]:
                group["index"] = self._upload(np.tile(idx, (info["n"], 1)))
            else:
                group["index"] = self._upload(idx)
            if info["ring"]:
                W = info["length"]
                shape = (info["n"], W) if info["scanned"] else (W,)
                pos = self._meta.get(rid, {}).get("pos", {}).get(name)
                group["pos"] = torch.full(shape, -1, dtype=torch.int32,
                                          device=info["device"]) \
                    if pos is None else pos
            view[name] = group
        view["block_tables"] = self._table_row(rid)
        return view

    def absorb_prefill(self, rid, new_cache: dict) -> None:
        """Absorb one prefill *chunk*'s pool writes (pk/pv plus the scale
        sidecars, ring write positions) without registering the prompt —
        `admit_finish` runs once, on the final chunk, when every prompt
        page holds its bytes."""
        meta = self._meta[rid]
        for name, info in self._groups.items():
            group = new_cache[name]
            self._pools[name] = self._pool_state(group)
            if info["ring"]:
                meta["pos"][name] = group["pos"]  # (W,) or (n, W)

    def admit_finish(self, rid, new_cache: dict, tokens) -> None:
        """Absorb the paged-prefill step's outputs (pools now hold the
        suffix K/V) and register the prompt in the prefix index."""
        self.absorb_prefill(rid, new_cache)
        self._register_prefix(rid, tokens)

    @staticmethod
    def _pool_state(group: dict) -> dict:
        """The shared pool arrays a step hands back: pk/pv plus the scale
        sidecars when the group is quantized."""
        state = {"pk": group["pk"], "pv": group["pv"]}
        for key in ("ksc", "vsc"):
            if key in group:
                state[key] = group[key]
        return state

    def admit_shared(self, rid, tokens, *, final_len: int,
                     pages: Sequence[int]) -> None:
        """Admit a full-prompt prefix hit: every prompt page is already
        resident, no prefill runs — the caller re-scores the last prompt
        token (`rescore_view`) for its first output logits.  The first
        decode write into the shared tail page splits it copy-on-write."""
        if not self._groups:
            raise RuntimeError("init_structure (or admit) must run first")
        toks = np.asarray(tokens, np.int64).reshape(-1)
        S = len(toks)
        self._check_family(S)
        if len(pages) != self._slots_needed(S):
            raise ValueError(
                f"full-prompt share needs {self._slots_needed(S)} pages, "
                f"got {len(pages)}")
        self.pool.alloc(rid, len(pages), shared=pages)
        self.prefix_hits += len(pages)
        self._new_meta(rid, S, final_len)

    def rescore_view(self, rid) -> dict:
        """Single-request decode cache view with index = length - 1: the
        no-write re-score of the last prompt token that yields a shared-
        admission's first output logits."""
        return self._compose([rid], index_offset=-1)

    # -- legacy admission (pack an existing dense prefill cache) -----------------

    def admit(self, rid, cache: dict, *, final_len: int) -> None:
        """Pack a per-request (batch=1) prefill cache into pool pages.

        `final_len` is the most cache slots this request will ever occupy
        (prompt + decode budget), reserved for deadlock-free growth.
        """
        if not self._groups:
            self._scan_structure(cache)
            self._ensure_pools(self.pool.num_pages)
        else:
            # every request must pack the same cache family per group:
            # Attention._build_cache rings only when window < prompt_len,
            # so a sliding-window batch straddling W would otherwise mix
            # ring and linear layouts in one pool — refuse loudly.
            for name, info in self._groups.items():
                group = cache[name]
                if ("pos" in group) != info["ring"] \
                        or group["k"].shape[-3] != info["length"]:
                    raise ValueError(
                        f"request cache family mismatch in group {name!r} "
                        f"(ring={'pos' in group}, "
                        f"len={group['k'].shape[-3]}) vs the pool's "
                        f"(ring={info['ring']}, len={info['length']}); "
                        "sliding-window serving needs prompts on one side "
                        "of the window — use serve_batch otherwise")
        ps = self.page_size
        length = None
        for name, info in self._groups.items():
            idx = cache[name]["index"]
            length = int(np.asarray(idx).reshape(-1)[0])
            break
        pages = self.pool.alloc(rid, self._slots_needed(length))
        pages_arr = torch.as_tensor(pages, dtype=torch.long,
                                    device=self._device())

        for name, info in self._groups.items():
            group = cache[name]
            for src_key, dst_key in (("k", "pk"), ("v", "pv")):
                arr = group[src_key]
                if info["scanned"]:
                    arr = arr[:, 0]  # (n, T, K, D)
                else:
                    arr = arr[0]     # (T, K, D)
                need = len(pages) * ps
                T = arr.shape[-3]
                if need > T:
                    arr = torch.cat([arr, arr.new_zeros(
                        (*arr.shape[:-3], need - T, *arr.shape[-2:]))], dim=-3)
                else:
                    arr = arr[..., :need, :, :]
                paged = arr.reshape(*arr.shape[:-3], len(pages), ps,
                                    *arr.shape[-2:])
                pools = self._pools[name]
                sc_key = {"pk": "ksc", "pv": "vsc"}[dst_key]
                if sc_key in pools:
                    # per-page-per-head absmax; the zero padding past the
                    # prompt neither raises it nor survives dequant
                    scale = kv_scale_from_absmax(
                        torch.amax(paged.to(torch.float32).abs(), dim=(-3, -1)),
                        pools[dst_key].dtype)
                    paged = quantize_kv_write(paged, scale[..., None, :],
                                              pools[dst_key].dtype)
                    if info["scanned"]:
                        pools[sc_key][:, pages_arr] = scale
                    else:
                        pools[sc_key][pages_arr] = scale
                if info["scanned"]:
                    pools[dst_key][:, pages_arr] = paged.to(pools[dst_key].dtype)
                else:
                    pools[dst_key][pages_arr] = paged.to(pools[dst_key].dtype)

        meta: dict[str, Any] = {
            "length": length,
            "final_len": int(final_len),
            "pos": {},
        }
        for name, info in self._groups.items():
            if info["ring"]:
                meta["pos"][name] = cache[name]["pos"]  # (W,) or (n, W)
        if "kv_pos" in cache:
            meta["kv_pos"] = cache["kv_pos"][0]  # (max_len,)
        self._meta[rid] = meta

    def retire(self, rid) -> None:
        freed = self.pool.release(rid)
        self._purge_keys(freed)
        self._pop_scales(freed)
        del self._meta[rid]

    def abort(self, rid) -> None:
        """Best-effort rollback of a partial admission (or a forced
        eviction): release the request's pages if it holds any and drop
        its meta — idempotent, so fault-isolation paths can call it
        without knowing how far the admission got.  Freed pages leave the
        prefix index and their scale-sidecar rows reset to the free-page
        sentinel, exactly as `retire` would."""
        if rid in self.pool.tables:
            freed = self.pool.release(rid)
            self._purge_keys(freed)
            self._pop_scales(freed)
        self._meta.pop(rid, None)

    def _pop_scales(self, freed: Sequence[int]) -> None:
        """Reset freed pages' sidecar rows to the free-page sentinel: a
        page's scale lives exactly as long as the page does."""
        idx = None
        for name in self._groups if freed else ():
            pools = self._pools.get(name)
            if pools and "ksc" in pools:
                if idx is None:  # one host-to-device copy, quantized pools only
                    idx = torch.as_tensor(list(freed), dtype=torch.long,
                                          device=pools["ksc"].device)
                _zero_scale_rows(pools["ksc"], idx)
                _zero_scale_rows(pools["vsc"], idx)

    # -- per-step batch composition ---------------------------------------------

    def _cow_for_write(self, rid, tokens: int = 1) -> None:
        """Split every shared page the request's next `tokens` decode slots
        would write: copy page -> remap table -> (the step then) writes.
        Runs before the decode step so the scatter lands in the private
        copies and shared pages are never mutated."""
        if not self.prefix_sharing or self._ring_pool():
            return
        m = self._meta[rid]
        start = m["length"]
        stop = start + tokens
        lin = self._linear_len()
        if lin is not None:
            stop = min(stop, lin)  # past-the-end writes are dropped
        if stop <= start:
            return
        table = self.pool.tables[rid]
        for pidx in range(start // self.page_size,
                          min(cdiv(stop, self.page_size), len(table))):
            split = self.pool.cow(rid, pidx)
            if split is None:
                continue
            old, new = split
            for name in self._groups:
                pools = self._pools[name]
                for key in ("pk", "pv"):
                    _copy_pool_page(pools[key], old, new)
                if "ksc" in pools:
                    # private copy dequantizes identically to the donor
                    _copy_scale_row(pools["ksc"], old, new)
                    _copy_scale_row(pools["vsc"], old, new)
            self.cow_splits += 1

    def batch(self, rids: list[Any], *, tokens: int = 1) -> dict:
        """Decode cache pytree for this step's active set, in `rids` order.

        Grows each request's tail pages to cover the `tokens` slots the
        step writes (tokens > 1: the speculative verify step's draft block)
        — clamped at the reserved `final_len`, so growth can never outrun
        the admission-time reservation — splits shared pages the step would
        write (copy-on-write), then stacks the per-request rows around the
        shared pools.
        """
        for rid in rids:
            m = self._meta[rid]
            target = min(m["length"] + tokens, m["final_len"])
            self.pool.grow_to(rid, self._slots_needed(target))
            self._cow_for_write(rid, tokens)
        return self._compose(rids)

    def _compose(self, rids: list[Any], *, index_offset: int = 0) -> dict:
        lengths = np.asarray(
            [self._meta[r]["length"] + index_offset for r in rids], np.int32)
        # the (B, NB) block table: one host-to-device copy per step, shared
        # by every layer (the model hoists it)
        tables = self._upload(self.pool.table_rows(rids, self.table_width))

        cache: dict[str, Any] = {}
        for name, info in self._groups.items():
            group: dict[str, Any] = dict(self._pools[name])
            if info["scanned"]:
                group["index"] = self._upload(np.tile(lengths, (info["n"], 1)))
            else:
                group["index"] = self._upload(lengths)
            if info["ring"]:
                rows = [self._meta[r]["pos"][name] for r in rids]
                group["pos"] = torch.stack(rows,
                                           dim=1 if info["scanned"] else 0)
            cache[name] = group
        cache["block_tables"] = tables
        if any("kv_pos" in self._meta[r] for r in rids):
            rows = []
            for r in rids:
                kvp = self._meta[r].get("kv_pos")
                if kvp is None:
                    # a legacy admit() of a hand-built cache may lack the
                    # hoisted map; synthesize it (slot s -> s while live —
                    # exactly what the decode steps would have maintained)
                    width = self._linear_len() or self.max_len
                    kvp = _live_positions(int(width), self._meta[r]["length"],
                                          self._device())
                    self._meta[r]["kv_pos"] = kvp
                rows.append(kvp)
            cache["kv_pos"] = torch.stack(rows, dim=0)
        return cache

    def absorb(self, rids: list[Any], new_cache: dict, *,
               advance: int = 1) -> None:
        """Store one decode step's outputs back: pools are shared (one
        assignment), per-request rows split on their batch axis.  A
        speculative verify step passes `advance` = its q span so lengths
        provisionally cover the whole draft block (rollback() then trims
        rejected tokens)."""
        for name, info in self._groups.items():
            group = new_cache[name]
            self._pools[name] = self._pool_state(group)
            if info["ring"]:
                axis = 1 if info["scanned"] else 0
                for i, rid in enumerate(rids):
                    self._meta[rid]["pos"][name] = group["pos"].select(axis, i)
        if "kv_pos" in new_cache:
            for i, rid in enumerate(rids):
                self._meta[rid]["kv_pos"] = new_cache["kv_pos"][i]
        for rid in rids:
            self._meta[rid]["length"] += advance

    def rollback(self, rid, new_length: int) -> list[int]:
        """Speculative-misprediction rollback: shrink the request to
        `new_length` live tokens in O(1) pool operations per tail page.

        Table entries past the slots `new_length` needs are released
        tail-first (refcount decrement — donor pages shared with other
        requests just lose this reference, their bytes are never touched
        or copied), freed pages are purged from the prefix index and their
        scale rows return to the free-page sentinel, and the hoisted
        `kv_pos` map is rewound so stale draft slots mask dead.  The
        over-written K/V bytes in still-held pages are left in place: they
        sit past the live boundary, so attention never reads them and the
        next decode step overwrites them.  Copy-on-write splits performed
        for the rejected write are *not* undone — the private copy holds
        the request's valid prefix slots.  Returns the pages actually
        freed."""
        m = self._meta[rid]
        if new_length < 0 or new_length > m["length"]:
            raise ValueError(
                f"rollback({rid!r}) to {new_length} outside [0, "
                f"{m['length']}]")
        m["length"] = new_length
        freed = self.pool.truncate(rid, self._slots_needed(new_length))
        if freed:
            self._purge_keys(freed)
            self._pop_scales(freed)
        if "kv_pos" in m:
            kvp = m["kv_pos"]
            ar = torch.arange(kvp.shape[-1], dtype=torch.int32, device=kvp.device)
            m["kv_pos"] = torch.where(ar < new_length, kvp, torch.full_like(kvp, -1))
        return freed

    # -- introspection -----------------------------------------------------------

    def _group_page_bytes(self, name: str, info: dict) -> int:
        """Per-live-page bytes of one group across its layers: quantized
        payload at the *pool* dtype plus the fp32 scale sidecar rows."""
        pools = self._pools.get(name)
        qdt = self._quant_dtype(info)
        dtype = pools["pk"].dtype if pools else (qdt or info["dtype"])
        quantized = ("ksc" in pools) if pools else qdt is not None
        per_page = 2 * (self.page_size * info["kv_heads"] * info["head_dim"]
                        * dtype.itemsize)
        if quantized:
            per_page += 2 * info["kv_heads"] * 4  # k + v fp32 scale rows
        layers = info["n"] if info["scanned"] else 1
        return layers * per_page

    def hbm_pool_bytes(self) -> int:
        """Allocated KV bytes: *distinct* live pages across every layer
        pool — shared prefix pages count once, quantized pools count their
        narrow payload plus scale sidecars."""
        return sum(self._group_page_bytes(name, info) * self.pool.live_pages
                   for name, info in self._groups.items())

    def stats(self) -> dict[str, Any]:
        """Pool economics snapshot: distinct vs mapped pages (the gap is
        the prefix-sharing saving), peak values, hit/split counters, and
        the dtype-aware pool HBM footprint (benches consume these instead
        of recomputing bytes by hand)."""
        bytes_now = self.hbm_pool_bytes()
        page_bytes = sum(self._group_page_bytes(name, info)
                         for name, info in self._groups.items())
        return {
            "num_pages": self.pool.num_pages,
            "page_size": self.page_size,
            "live_pages": self.pool.live_pages,
            "mapped_pages": self.pool.mapped_pages,
            "peak_live_pages": self.pool.peak_live,
            "peak_mapped_pages": self.pool.peak_mapped,
            "prefix_hits": self.prefix_hits,
            "cow_splits": self.cow_splits,
            "hbm_pool_bytes": bytes_now,
            "pool_hbm_bytes": bytes_now,
            "peak_pool_hbm_bytes": page_bytes * self.pool.peak_live,
            "page_hbm_bytes": page_bytes,
            "cache_dtype": (str(self.cache_dtype).removeprefix("torch.")
                            if self.cache_dtype is not None else None),
        }


# ---------------------------------------------------------------------------
# Invariant auditing (fault-isolation debug barrier)
# ---------------------------------------------------------------------------


class PoolInvariantError(RuntimeError):
    """A pool/manager invariant does not hold — state corruption caught at
    the barrier where it happened, not three steps later."""


class PoolAuditor:
    """Invariant checker over a PagePool (and optionally the manager that
    owns it).  Run at retire/rollback barriers under the `pool_audit`
    debug knob: every check is host-side bookkeeping except the
    scale-sidecar sentinel check, which is gated separately because it
    reads the device.

    Invariants:
      * refcount conservation — every page's refcount equals the number
        of table entries mapping it, across all live tables;
      * free/referenced disjointness — no page is both on the free list
        and referenced (and the free list holds no duplicates);
      * conservation — free + distinct referenced pages partition the
        pool exactly;
      * table liveness — every table entry is a valid page id with
        refcount >= 1, and no table maps the same page at two logical
        positions;
      * manager consistency — tables and per-request meta cover the same
        request ids, each table spans the pages its live length needs and
        never exceeds its `final_len` reservation, and every prefix-index
        entry points at a live page;
      * scale-sidecar consistency (`check_device=True`) — free pages'
        quantization scale rows sit at the 0.0 free-page sentinel (one
        reduction on the device and one scalar read back per sidecar).
    """

    def __init__(self, target: "PagePool | PagedCacheManager", *,
                 check_device: bool = False):
        if isinstance(target, PagedCacheManager):
            self.manager: PagedCacheManager | None = target
            self.pool = target.pool
        else:
            self.manager = None
            self.pool = target
        self.check_device = check_device

    def _fail(self, violations: list[str]) -> None:
        if violations:
            raise PoolInvariantError(
                "pool invariant violation(s): " + "; ".join(violations))

    def audit(self) -> dict[str, Any]:
        """Check every invariant; raises PoolInvariantError on the first
        audit with violations, returns a summary dict otherwise."""
        pool = self.pool
        bad: list[str] = []
        free = list(pool._free)
        free_set = set(free)
        if len(free) != len(free_set):
            bad.append("free list holds duplicate pages")
        mapped: dict[int, int] = {}
        for rid, table in pool.tables.items():
            seen_here: set[int] = set()
            for logical, p in enumerate(table):
                if not (0 <= p < pool.num_pages):
                    bad.append(f"table {rid!r}[{logical}] = {p} out of range")
                    continue
                if p in seen_here:
                    bad.append(f"table {rid!r} maps page {p} twice")
                seen_here.add(p)
                mapped[p] = mapped.get(p, 0) + 1
        for p in range(pool.num_pages):
            refs = pool._refs[p]
            n_mapped = mapped.get(p, 0)
            if refs != n_mapped:
                bad.append(
                    f"page {p}: refcount {refs} != {n_mapped} table entries")
            if p in free_set and refs > 0:
                bad.append(f"page {p} both free and referenced ({refs})")
            if p not in free_set and refs == 0:
                bad.append(f"page {p} neither free nor referenced (leak)")
        if len(free_set) + len(mapped) != pool.num_pages:
            bad.append(
                f"conservation: {len(free_set)} free + {len(mapped)} live "
                f"!= {pool.num_pages} pages")
        checks = 4
        if self.manager is not None:
            checks += self._audit_manager(bad)
        self._fail(bad)
        return {"checks": checks, "live_pages": len(mapped),
                "free_pages": len(free_set),
                "requests": len(pool.tables)}

    def _audit_manager(self, bad: list[str]) -> int:
        mgr = self.manager
        pool = self.pool
        if set(pool.tables) != set(mgr._meta):
            bad.append(
                f"tables {sorted(map(repr, pool.tables))} != meta "
                f"{sorted(map(repr, mgr._meta))}")
        for rid, meta in mgr._meta.items():
            table = pool.tables.get(rid)
            if table is None:
                continue
            if mgr._groups:
                need = mgr._slots_needed(meta["length"])
                cap = mgr._slots_needed(meta["final_len"])
                if len(table) < need:
                    bad.append(
                        f"table {rid!r} holds {len(table)} pages, live "
                        f"length {meta['length']} needs {need}")
                if len(table) > cap:
                    bad.append(
                        f"table {rid!r} holds {len(table)} pages past its "
                        f"final_len reservation ({cap})")
        for key, page in mgr._prefix_index.items():
            if not (0 <= page < pool.num_pages) or pool._refs[page] <= 0:
                bad.append(f"prefix key {key[:2]} maps dead page {page}")
        checks = 3
        if self.check_device:
            checks += self._audit_sidecars(bad)
        return checks

    def _audit_sidecars(self, bad: list[str]) -> int:
        mgr = self.manager
        free = sorted(self.pool._free)
        if not free:
            return 1
        for name in mgr._groups:
            pools = mgr._pools.get(name)
            if not pools or "ksc" not in pools:
                continue
            idx = torch.as_tensor(free, dtype=torch.long, device=pools["ksc"].device)
            for key in ("ksc", "vsc"):
                if bool(pools[key].index_select(-2, idx).ne(0.0).any()):
                    bad.append(
                        f"group {name!r} {key} sidecar: free pages hold "
                        "non-sentinel scales")
        return 1


def audit_pool(target, **kwargs) -> dict[str, Any]:
    """One-shot invariant audit — `PoolAuditor(target).audit()`."""
    return PoolAuditor(target, **kwargs).audit()


# ---------------------------------------------------------------------------
# Raw-array pool packing (kernel-level tests and measurements)
# ---------------------------------------------------------------------------


def build_linear_pool(ks, vs, page_size: int, *, max_len: int | None = None,
                      num_pages: int | None = None):
    """Pack per-request linear cache prefixes (T_i, K, D) into one pool.

    Returns (pk, pv, tables, pool): pool tensors (P, page_size, K, D), block
    tables (B, ceil(max_len/page_size)) int32, and the PagePool.  For tests
    and measurements that drive `flash_decode` directly without a model; the
    pool lies where the first request's K lies."""
    lengths = [int(k.shape[0]) for k in ks]
    max_len = max_len or max(lengths)
    need = sum(cdiv(l, page_size) for l in lengths)
    pool = PagePool(num_pages or need, page_size)
    width = cdiv(max_len, page_size)
    k0 = torch.as_tensor(ks[0])
    pk = torch.zeros((pool.num_pages, page_size, *k0.shape[-2:]), dtype=k0.dtype,
                     device=k0.device)
    pv = torch.zeros_like(pk)
    for i, (k, v, l) in enumerate(zip(ks, vs, lengths)):
        pages = pool.alloc(i, cdiv(l, page_size))
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        for j, p in enumerate(pages):
            lo, hi = j * page_size, min((j + 1) * page_size, l)
            pk[p, : hi - lo] = k[lo:hi]
            pv[p, : hi - lo] = v[lo:hi]
    tables = torch.from_numpy(pool.table_rows(range(len(ks)), width)).to(pk.device)
    return pk, pv, tables, pool


def quantize_linear_pool(pk, pv, cache_dtype: str):
    """Quantize a `build_linear_pool` pool to (qpk, qpv, ksc, vsc): per-page-
    per-head absmax scales ((P, K) fp32, 0.0 on all-zero free pages), codes
    at the requested cache dtype.  Serving pools quantize at write time
    inside Attention."""
    dt = resolve_cache_dtype(cache_dtype)
    if dt is None:
        raise ValueError(f"not a quantized cache dtype: {cache_dtype!r}")
    ksc = kv_scale_from_absmax(pk.to(torch.float32).abs().amax(dim=(-3, -1)), dt)
    vsc = kv_scale_from_absmax(pv.to(torch.float32).abs().amax(dim=(-3, -1)), dt)
    qpk = quantize_kv_write(pk, ksc[..., None, :], dt)
    qpv = quantize_kv_write(pv, vsc[..., None, :], dt)
    return qpk, qpv, ksc, vsc
