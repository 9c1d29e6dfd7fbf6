"""Plain torch versions of the kernels on the ported paths: the port's
counterparts of ``attention_naive``, ``paged_attention_naive``,
``combine_partial_attention``, ``mamba_chunk_scan_naive``,
``mamba_chunk_scan_blocked``, ``mamba_decode_step``, ``fmmu_lookup_ref``
and ``fmmu_translate_ref`` in ``repro/kernels/ref.py``.

They run on any device. The kernel wrappers use them for CPU tensors,
``Runtime.kernel_impl="ref"`` selects them explicitly, and the card's
smoke run holds each CUDA kernel against them on the same inputs.

Conventions as in the reference: activations [B, S, H, D]; KV may have
fewer heads (GQA), grouped as kv head = h // (H // KV); softmax
statistics in float32.

One documented divergence from the jnp oracles: a query row with no
valid key (a decode lane with ``ctx_lens == 0``) returns 0 with stats
m = -1e30, l = 0 — what the Pallas kernels return, since they skip every
masked page — where the jnp oracles return the mean of the masked
values. The serving engine never passes such a row.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


def _masked_softmax_weights(logits: torch.Tensor, mask: torch.Tensor):
    """exp(logits - max) with masked entries exactly 0 -> (p, m, l)."""
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]),
                    torch.zeros_like(logits))
    return p, m, p.sum(dim=-1)


# ======================================================================
def attention_naive(q, k, v, *, causal=True, window=0, softcap=0.0,
                    bidirectional=False):
    """q [B,Sq,H,D]; k,v [B,Skv,KV,D] -> [B,Sq,H,D]. fp32 math;
    causal masking is right-aligned (query i sits at i + Skv - Sq)."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kv, dim=2)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    qf = q.float() * (1.0 / math.sqrt(d))
    logits = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kf), softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal and not bidirectional:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    p, _, l = _masked_softmax_weights(logits, mask[None, None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ======================================================================
def paged_attention_naive(q, k_pool, v_pool, block_table, ctx_lens, *,
                          softcap=0.0, window=0, return_stats=False):
    """One-token decode attention over a paged KV pool.

    q           [B, H, D]
    k/v_pool    [NB, P, KV, D]   physical blocks (pages of P tokens)
    block_table [B, MAXP] int32  logical page i of seq b -> physical block
    ctx_lens    [B] int32        tokens of context
    returns     [B, H, D]  (+ (m, l) fp32 [B, H] if return_stats)

    Table entries are clamped into [0, NB) like a jnp gather; the engine
    masks NIL and host-tier ids to its scratch block before the call.
    """
    b, h, d = q.shape
    nb, p, kv, _ = k_pool.shape
    maxp = block_table.shape[1]
    table = block_table.long().clamp(0, nb - 1)
    kseq = k_pool[table].float().reshape(b, maxp * p, kv, d)
    vseq = v_pool[table].float().reshape(b, maxp * p, kv, d)
    kseq = kseq.repeat_interleave(h // kv, dim=2)
    vseq = vseq.repeat_interleave(h // kv, dim=2)
    qf = q.float() * (1.0 / math.sqrt(d))
    logits = _softcap(torch.einsum("bhd,bkhd->bhk", qf, kseq), softcap)
    pos = torch.arange(maxp * p, device=q.device)[None, :]
    ctx = ctx_lens.long()[:, None]
    mask = pos < ctx
    if window and window > 0:
        mask &= pos >= ctx - window
    pexp, m, l = _masked_softmax_weights(logits, mask[:, None, :])
    out = torch.einsum("bhk,bkhd->bhd", pexp, vseq) / \
        l.clamp_min(1e-30)[..., None]
    if return_stats:
        return out.to(q.dtype), (m, l)
    return out.to(q.dtype)


def combine_partial_attention(outs, ms, ls, *, return_stats=False):
    """Combine flash-decoding partials along a leading split axis: the
    plain version of the paged kernel's in-launch reduction.

    outs [K,B,H,D] (each l-normalised over its own split), ms/ls [K,B,H]
    float32 -> out [B,H,D] float32 (+ (m, l) [B,H] if return_stats).
    An empty split (m = -1e30, l = 0) weighs nothing; all splits empty
    give 0 with m = -1e30, l = 0."""
    m = ms.amax(dim=0)
    w = torch.exp(ms - m[None]) * ls                  # effective weights
    denom = w.sum(dim=0)
    out = (outs * w[..., None]).sum(dim=0) / \
        denom.clamp_min(1e-30)[..., None]
    if return_stats:
        return out, (m, denom)
    return out


# ======================================================================
def fmmu_translate_ref(tags, valid, refbits, data, backing, dlpns, touch, *,
                       entries_per_block):
    """Fused translate probe: CMT probe + backing-table fallback +
    ref-bit touch (the single-probe pipeline of core/fmmu/batch).

    tags    [S, W] int32   block id (dlpn // entries_per_block) per way
    valid   [S, W] bool
    refbits [S, W] bool    second-chance reference bits
    data    [S, W, E] int32 DPPN entries
    backing [NP] int32     full flat map table
    dlpns   [Bq] int32     query DLPNs (-1 = inactive slot)
    touch   [Bq] bool      lanes whose hit should set the ref bit
    returns (hit [Bq] bool, out [Bq] int32, set_idx, way [Bq] int32,
             refbits' [S, W] bool)

    ``//`` and ``mod`` follow Python's floor rules, as jnp's do: an
    inactive lane with dlpn -1 reports set S-1. ``way`` is the FIRST
    matching way (argmax), 0 when nothing matches.
    """
    n_sets, n_ways = tags.shape
    e = entries_per_block
    dl = dlpns.long()
    block_id = torch.div(dl, e, rounding_mode="floor")
    offset = torch.remainder(dl, e)
    set_idx = torch.remainder(block_id, n_sets)
    active = dl >= 0
    match = (tags[set_idx].long() == block_id[:, None]) & valid[set_idx]
    hit = match.any(dim=1) & active
    way = match.to(torch.int32).argmax(dim=1)
    cached = data[set_idx, way, offset]
    backing_val = backing[dl.clamp(0, backing.shape[0] - 1)]
    nil = torch.full_like(backing_val, -1)
    out = torch.where(hit, cached, torch.where(active, backing_val, nil))
    # OR of the touching hit lanes into their (set, way) bit: a count
    # per bit, so duplicate lanes need no write ordering
    touched = torch.zeros(n_sets * n_ways, dtype=torch.int32,
                          device=tags.device)
    touched.index_add_(0, set_idx * n_ways + way,
                       (hit & touch.bool()).to(torch.int32))
    new_ref = refbits | (touched > 0).reshape(refbits.shape)
    return (hit, out.to(torch.int32), set_idx.to(torch.int32),
            way.to(torch.int32), new_ref)


# ======================================================================
def mamba_chunk_scan_naive(x, dt, A, B, C, D, *, chunk, initial_state=None):
    """Sequential-scan oracle for the Mamba2 SSD op (float32 math).

    x  [Bt, S, H, P]   (P = head dim)
    dt [Bt, S, H]      (already softplus'd, >= 0)
    A  [H]             (negative; decay = exp(dt * A))
    B  [Bt, S, N]      (single group, shared across heads)
    C  [Bt, S, N]
    D  [H]             skip
    returns y [Bt, S, H, P] in x's dtype, final_state [Bt, H, P, N] f32

    ``chunk`` is the blocking of the chunked lowerings; the sequential
    recurrence does not depend on it."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    state = (initial_state.float().clone() if initial_state is not None
             else torch.zeros((bt, h, p, n), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * Af[None, :])                 # [Bt,H]
        state = state * da[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bt, 0, h, p))
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def _segsum(a):
    """a [..., L] log-decays -> [..., L, L] lower-triangular cumulative
    sums: out[i, j] = sum_{k=j+1..i} a[k] for i >= j, else -inf."""
    n = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    idx = torch.arange(n, device=a.device)
    mask = idx[:, None] >= idx[None, :]
    return diff.masked_fill(~mask, -math.inf)


def mamba_chunk_scan_blocked(x, dt, A, B, C, D, *, chunk,
                             initial_state=None):
    """Chunked SSD (Dao & Gu 2024, Alg. 1), the arithmetic of the bf16
    scan kernel in float32: per chunk the intra-chunk product
    (C B^T * exp(segsum)) (dt x), the state entering the chunk decayed
    to each row, and the chunk's state update; S not a multiple of
    ``chunk`` falls back to the naive scan, as in the reference. Used by
    the tests and the card's timing line, never on the serving path."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        return mamba_chunk_scan_naive(x, dt, A, B, C, D, chunk=chunk,
                                      initial_state=initial_state)
    nc = s // chunk
    xf = x.float().reshape(bt, nc, chunk, h, p)
    dtf = dt.float().reshape(bt, nc, chunk, h)
    Bf = B.float().reshape(bt, nc, chunk, n)
    Cf = C.float().reshape(bt, nc, chunk, n)
    a = (dtf * A.float()[None, None, None, :]).movedim(-1, 2)  # [bt,nc,h,L]
    a_cum = torch.cumsum(a, dim=-1)
    lmat = torch.exp(_segsum(a))                           # [bt,nc,h,L,L]
    cb = torch.einsum("bcln,bcmn->bclm", Cf, Bf)
    dtx = dtf[..., None] * xf
    y_diag = torch.einsum("bclm,bchlm,bcmhp->bclhp", cb, lmat, dtx)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)      # [bt,nc,h,L]
    states = torch.einsum("bchl,bcln,bclhp->bchpn", decay_to_end, Bf, dtx)
    chunk_decay = torch.exp(a_cum[..., -1])                # [bt,nc,h]
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((bt, h, p, n), dtype=torch.float32,
                              device=x.device))
    prev = []                                   # state entering chunk c
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # [bt,nc,h,p,n]
    y_off = torch.einsum("bcln,bchl,bchpn->bclhp", Cf, torch.exp(a_cum),
                         prev_states)
    y = (y_diag + y_off).reshape(bt, s, h, p)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def mamba_decode_step(state, x, dt, A, B, C, D):
    """Single-token SSD recurrence. state [Bt,H,P,N] f32; x [Bt,H,P];
    dt [Bt,H]; B,C [Bt,N]. Returns (y [Bt,H,P] in x's dtype,
    new_state f32)."""
    da = torch.exp(dt.float() * A.float()[None, :])
    xf = x.float()
    state = state * da[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt.float(), xf, B.float())
    y = torch.einsum("bhpn,bn->bhp", state, C.float())
    y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), state


# ======================================================================
def fmmu_lookup_ref(tags, valid, data, dlpns, *, entries_per_block):
    """Probe-only CMT lookup (no side effects).

    tags  [S, W] int32   block id (dlpn // entries_per_block) per way
    valid [S, W] bool
    data  [S, W, E] int32 DPPN entries
    dlpns [Bq] int32     query DLPNs (-1 = inactive slot)
    returns (hit [Bq] bool, dppn [Bq] int32 (-1 on a miss), set_idx,
             way [Bq] int32)

    Floor ``//`` and ``mod`` as jnp's; ``way`` is the FIRST matching way
    (argmax), 0 when nothing matches. Tags compare as integers, so block
    ids at and above 1<<24 are exact."""
    n_sets, _ = tags.shape
    e = entries_per_block
    dl = dlpns.long()
    block_id = torch.div(dl, e, rounding_mode="floor")
    offset = torch.remainder(dl, e)
    set_idx = torch.remainder(block_id, n_sets)
    match = (tags[set_idx].long() == block_id[:, None]) & valid[set_idx]
    hit = match.any(dim=1) & (dl >= 0)
    way = match.to(torch.int32).argmax(dim=1)
    dppn = torch.where(hit, data[set_idx, way, offset],
                       torch.full_like(dlpns, -1))
    return (hit, dppn.to(torch.int32), set_idx.to(torch.int32),
            way.to(torch.int32))
