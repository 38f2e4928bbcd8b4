"""Plain PyTorch versions of the RWKV6 WKV recurrence.

Per head (k-dim i, v-dim j), fp32 state S in R^{C x C}:

    y_t[j] = sum_i r_t[i] * S_{t-1}[i,j]  +  (sum_i r_t[i] u[i] k_t[i]) * v_t[j]
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]

`wkv_scan` is the sequential form — the function the CUDA kernel computes,
and what the kernel wrapper runs for a CPU tensor.  `wkv_chunked` is the
chunked parallel form, the plain implementation the model takes when no
kernel is woven: within a chunk all pairwise decay factors are exponentials
of *non-positive* log-decay differences, so the math is stable for any decay
magnitude.  `wkv_chunk_parallel` is the plain twin of the CUDA kernel: the
chunked form in the kernel's three phases and its factoring of the decays.
All take r, k, v, w (B,S,H,C), u (H,C), s0 (B,H,C,C) and return y
(B,S,H,C) in r's dtype and the last state (B,H,C,C) fp32.
"""

from __future__ import annotations

import torch


def wkv_scan(r, k, v, w, u, s0):
    rf, kf, vf, wf = (x.to(torch.float32) for x in (r, k, v, w))
    uf = u.to(torch.float32)
    s = s0.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]  # (B,H,C)
        y = torch.einsum("bhi,bhij->bhj", rt, s)
        coef = (rt * uf * kt).sum(-1)
        ys.append(y + coef[..., None] * vt)
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv_chunked(r, k, v, w, u, s0, *, chunk: int = 32):
    """Chunked parallel form; the semantics of `wkv_scan`."""
    B, S, H, C = r.shape
    L = min(chunk, S)
    pad = (-S) % L
    rf, kf, vf, wf = (x.to(torch.float32) for x in (r, k, v, w))
    if pad:  # padded steps have w = 1, k = 0: the state passes unchanged
        zeros = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        rf, kf, vf = zeros(rf), zeros(kf), zeros(vf)
        wf = torch.nn.functional.pad(wf, (0, 0, 0, 0, 0, pad), value=1.0)
    N = (S + pad) // L

    def to_chunks(x):  # (B, N*L, H, C) -> (N, B, H, L, C)
        return x.reshape(B, N, L, H, C).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_chunks, (rf, kf, vf, wf))
    uf = u.to(torch.float32)
    lw = torch.log(torch.clamp(wc, min=1e-30))  # <= 0
    li = torch.cumsum(lw, dim=3)
    li_prev = torch.cat([torch.zeros_like(li[..., :1, :]), li[..., :-1, :]], dim=3)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    eye = torch.eye(L, dtype=torch.float32, device=r.device)

    s = s0.to(torch.float32)
    ys = []
    for n in range(N):
        rn, kn, vn, li_n, lip_n = rc[n], kc[n], vc[n], li[n], li_prev[n]
        q_dec = rn * torch.exp(lip_n)  # decay-weighted receptance (exp <= 1)
        y_state = torch.einsum("bhic,bhcj->bhij", q_dec, s)
        # pairwise intra-chunk decays exp(li_{i-1} - li_j) for j < i (<= 1)
        diff = lip_n[:, :, :, None, :] - li_n[:, :, None, :, :]  # (B,H,L,L,C)
        dmat = torch.exp(torch.clamp(diff, max=0.0))
        a = torch.einsum("bhic,bhjc,bhijc->bhij", rn, kn, dmat)
        a = torch.where(causal, a, torch.zeros_like(a))
        a_diag = torch.einsum("bhic,hc,bhic->bhi", rn, uf, kn)
        a = a + eye * a_diag[..., None]
        ys.append(y_state + torch.einsum("bhij,bhjc->bhic", a, vn))
        # state to the next chunk: diag(exp(li_L)) S + sum_j (k_j exp(li_L - li_j)) v_j^T
        end = li_n[:, :, -1:, :]  # (B,H,1,C)
        k_dec = kn * torch.exp(torch.clamp(end - li_n, max=0.0))
        s = torch.exp(end[:, :, 0])[..., None] * s + torch.einsum("bhjc,bhjv->bhcv", k_dec, vn)
    y = torch.stack(ys, dim=0)  # (N, B, H, L, C)
    y = y.permute(1, 0, 3, 2, 4).reshape(B, N * L, H, C)
    return y[:, :S].to(r.dtype), s


def wkv_chunk_parallel(r, k, v, w, u, s0, *, chunk: int = 32):
    """The plain twin of the CUDA kernel (`csrc/wkv6.cu`), in its order:

    1. per chunk alone: li = cumsum(log max(w, 1e-30)) in step order, the
       state increment dS = (k exp(li_L - li))^T v and the decay exp(li_L);
    2. the states entering the chunks, S_{n+1} = exp(li_L) S_n + dS_n;
    3. per chunk: y = (r exp(li_prev)) S_n + A v, with A's 16-step diagonal
       sub-blocks from the pairwise decays — exp(li_{i-1} - li_j) as the
       running product of max(w_m, 1e-30) over j < m < i — and its blocks
       left of them factored at the boundary b = 16 I - 1, r^_i = r_i
       exp(li_{i-1} - li_b), k^_j = k_j exp(li_b - li_j) — every exponent
       and every factor <= 0 and <= 1.

    Missing steps of a ragged last chunk read as w = 1, k = r = v = 0.  All
    fp32; the semantics of `wkv_scan`."""
    B, S, H, C = r.shape
    L = int(chunk)
    if L % 16:
        raise ValueError(f"the chunk is a multiple of 16 steps, got {L}")
    N = -(-S // L)
    pad = N * L - S

    def chunks(x, value=0.0):  # (B, S, H, C) -> (B, H, N, L, C), padded
        x = torch.nn.functional.pad(x.to(torch.float32), (0, 0, 0, 0, 0, pad), value=value)
        return x.reshape(B, N, L, H, C).permute(0, 3, 1, 2, 4)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    wc = torch.clamp(chunks(w, 1.0), min=1e-30)
    lw = torch.log(wc)
    run = torch.zeros_like(lw[..., 0, :])
    li = torch.empty_like(lw)
    for t in range(L):  # step order, in fp32
        run = run + lw[..., t, :]
        li[..., t, :] = run
    li_prev = torch.cat([torch.zeros_like(li[..., :1, :]), li[..., :-1, :]], dim=-2)

    # 1. each chunk's state increment and decay
    end = li[..., -1:, :]
    k_dec = kc * torch.exp(torch.clamp(end - li, max=0.0))
    ds = torch.einsum("bhntc,bhntj->bhncj", k_dec, vc)
    decay = torch.exp(end[..., 0, :])  # (B, H, N, C)
    # 2. the states entering each chunk
    s = s0.to(torch.float32)
    entering = []
    for n in range(N):
        entering.append(s)
        s = decay[:, :, n, :, None] * s + ds[:, :, n]
    st = torch.stack(entering, dim=2)  # (B, H, N, C, C)
    # 3. each chunk's output
    a = torch.zeros(rc.shape[:-1] + (L,), dtype=torch.float32, device=r.device)
    uf = u.to(torch.float32)[None, :, None, None, :]
    steps = torch.arange(16, device=r.device)
    for blk in range(L // 16):
        rows = slice(16 * blk, 16 * blk + 16)
        rb, kb, wb = rc[..., rows, :], kc[..., rows, :], wc[..., rows, :]
        ab = torch.zeros(rb.shape[:-1] + (16,), dtype=torch.float32, device=r.device)
        ab[..., steps, steps] = (rb * uf * kb).sum(-1)
        d = torch.ones_like(kb)  # d[j] = prod of the decays strictly between j and i
        for delta in range(1, 16):
            jj = steps[:16 - delta]
            ab[..., jj + delta, jj] = (rb[..., jj + delta, :] * kb[..., jj, :]
                                       * d[..., jj, :]).sum(-1)
            d[..., jj, :] = d[..., jj, :] * wb[..., jj + delta, :]
        a[..., rows, rows] = ab
        if blk:
            bnd = li[..., 16 * blk - 1:16 * blk, :]
            r_hat = rc[..., rows, :] * torch.exp(torch.clamp(li_prev[..., rows, :] - bnd,
                                                             max=0.0))
            k_hat = kc[..., :16 * blk, :] * torch.exp(torch.clamp(bnd - li[..., :16 * blk, :],
                                                                  max=0.0))
            a[..., rows, :16 * blk] = torch.einsum("...ic,...jc->...ij", r_hat, k_hat)
    y = torch.einsum("...tc,...cj->...tj", rc * torch.exp(li_prev), st) \
        + torch.einsum("...ij,...jc->...ic", a, vc)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, N * L, H, C)[:, :S]
    return y.to(r.dtype), s
