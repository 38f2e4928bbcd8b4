"""AdamW with fp32 master weights, global-norm clipping, bias correction and
optional int8 error-feedback gradient compression (optim/compression.py).

The formulas and their order of operations are the reference's
(`repro/optim/adamw.py`).  What differs is memory: PyTorch updates in place.
`apply_updates` overwrites the master weights, m, v and the parameters
themselves, works leaf by leaf (so its fp32 transients are those of one
leaf, not of the whole tree), and may overwrite the fp32 gradients it is
handed (they are donated, as the reference's train step donates its
buffers).  The state is a dict of param-shaped trees plus a 0-dim int32
`count` on the parameters' device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.optim.compression import ef_compress
from repro_torch.optim.tree import leaves, rebuild, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compression: bool = False  # int8 EF quantize-dequant on grads
    state_dtype: str = "float32"  # m/v dtype: "float32" | "bfloat16" (memory knob)


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def init_state(params, cfg: AdamWConfig) -> dict:
    sdt = _state_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)
    flat = leaves(params)
    device = flat[0].device if flat else torch.device("cpu")
    state = {
        # a copy even where the param is fp32 already (norms): the master is
        # updated in place and must not alias the live parameter
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.compression:
        state["ef"] = tree_map(zeros, params)
    return state


def global_norm(tree, mesh=None, split=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in fp32 (one leaf's square
    at a time).  On a live mesh, `split[i]` holds the mesh axes leaf i is
    split over (a Megatron block over `model`, an FSDP block over `data`
    and / or `model`): its squares are summed over those axes (one
    all-reduce per axis for all the leaves split alike), and a replicated
    leaf counts once."""
    parts: dict[tuple, torch.Tensor | float] = {}
    for i, g in enumerate(leaves(tree)):
        axes = tuple(split[i]) if split is not None else ()
        parts[axes] = parts.get(axes, 0.0) + torch.sum(torch.square(g.to(torch.float32)))
    total = parts.pop((), 0.0)
    if parts:
        from repro_torch.distributed.collectives import all_reduce

        for axes, sq in parts.items():
            for a in axes:
                sq = all_reduce(sq, mesh, a)
            total = total + sq
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


# elements of a leaf updated at once: the update's fp32 temporaries stay
# within 128 MB each however large a stacked leaf is (rwkv6-3b's stacked
# channel-mix weights hold 734 M elements, 2.9 GB a temporary; a whole-leaf
# update ran its full-width training out of memory on an 80 GB card)
UPDATE_SLICE = 1 << 25


def _update_slice(p, g, master, m, v, cfg, c1, c2, lr):
    """The elementwise AdamW update of one slice, in place."""
    m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
    m.copy_(m_new)
    del m_new
    v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g)
    v.copy_(v_new)
    del v_new
    mh = m.to(torch.float32) / c1
    vh = v.to(torch.float32) / c2
    step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * master
    del mh, vh
    master.sub_(lr * step)
    del step
    p.copy_(master)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, lr, *, mesh=None,
                  split=None, rows=None):
    """Returns (params, state, metrics) — the same param tensors, updated in
    place, and the state with master / m / v updated in place (a new
    `count`; under compression new fp32 `ef` leaves, as the reference's
    residuals are fp32 whatever `state_dtype` says).  `grads` may be bf16
    (converted one leaf at a time) or fp32 (donated: scaled in place).  A
    leaf is updated `UPDATE_SLICE` elements at a time: the update is
    elementwise, so the slices give the whole leaf's bits.  `mesh` and
    `split`: the clipping norm of a live mesh's shards (`global_norm`);
    `rows[i]`, the axes that split leaf i's last dim, over which
    compression takes a row's scale (`compression.ef_compress`, which reads
    the whole leaf's size from `split`).  The state lives per shard:
    master, m, v and `ef` are shaped like the rank's blocks."""
    flat_g = leaves(grads)
    gnorm = global_norm(grads, mesh, split)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    count = state["count"] + 1
    countf = count.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** countf
    c2 = 1.0 - cfg.b2 ** countf
    lr = torch.as_tensor(lr, dtype=torch.float32)

    flat_p = leaves(params)
    flat_master = leaves(state["master"])
    flat_m = leaves(state["m"])
    flat_v = leaves(state["v"])
    flat_ef = leaves(state["ef"]) if cfg.compression else [None] * len(flat_p)
    new_ef = []
    for i, (p, g, master, m, v, ef) in enumerate(zip(flat_p, flat_g, flat_master, flat_m,
                                                     flat_v, flat_ef)):
        g = g.to(torch.float32) if g.dtype != torch.float32 else g
        g.mul_(scale)
        if cfg.compression:
            shard = {} if split is None else {
                "mesh": mesh, "row_axes": rows[i],
                "numel": g.numel() * math.prod(mesh.shape[a] for a in split[i])}
            g, ef = ef_compress(g, ef, **shard)
            new_ef.append(ef)
        flat = [t.view(-1) for t in (p, master, m, v)] + [g.reshape(-1)]
        del g
        lr_d = lr.to(master.device)
        for lo in range(0, p.numel(), UPDATE_SLICE):
            pp, mp, mm, vv, gg = (t[lo:lo + UPDATE_SLICE] for t in flat)
            _update_slice(pp, gg, mp, mm, vv, cfg, c1, c2, lr_d)
        del flat

    new_state = {"master": state["master"], "m": state["m"], "v": state["v"],
                 "count": count}
    if cfg.compression:
        new_state["ef"] = rebuild(state["ef"], new_ef)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, new_state, metrics
