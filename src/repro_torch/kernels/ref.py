"""Plain torch versions of the kernels on the ported paths: the port's
counterparts of ``attention_naive``, ``paged_attention_naive``,
``combine_partial_attention``, ``mamba_chunk_scan_naive``,
``mamba_chunk_scan_blocked``, ``mamba_decode_step``, ``fmmu_lookup_ref``
and ``fmmu_translate_ref`` in ``repro/kernels/ref.py``; and for the
flash kernel's backward, which the reference takes with ``jax.grad``
through its blocked lowering, ``attention_lse`` (the forward with the
row log-sum-exp it saves), ``flash_attention_bwd_ref`` and
``flash_attention_bwd_blocked`` (the kernels' tile walk and their
segment-span skip, ``tile_spans`` / ``spans_meet``); for the scan's
backward, which the reference also takes with ``jax.grad``,
``mamba_chunk_scan_bwd_ref`` (autograd through the naive scan) and
``mamba_chunk_scan_bwd_blocked`` (the backward kernel's arithmetic).

They run on any device. The kernel wrappers use them for CPU tensors,
``Runtime.kernel_impl="ref"`` selects them explicitly, and the card's
smoke run holds each CUDA kernel against them on the same inputs.

Conventions as in the reference: activations [B, S, H, D]; KV may have
fewer heads (GQA), grouped as kv head = h // (H // KV); softmax
statistics in float32.

One documented divergence from the jnp oracles: a query row with no
valid key (a decode lane with ``ctx_lens == 0``, a cross-attention lane
with no valid source frame, a causal row past Skv) returns 0 with stats
m = -1e30, l = 0 — what the Pallas kernels return, since they skip every
masked page — where the jnp oracles return the mean of the masked
values (their -1e30 is finite). The CUDA kernels return 0 too. The
serving engine passes such a row only on a masked (dead or paused)
lane, whose source mask it zeroes and whose token it discards.
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
def _attention_logits(q, k, *, causal, window, softcap, segment_ids,
                      bidirectional):
    """Scaled fp32 logits before and after the softcap [B,H,Sq,Skv] and
    the mask of the (query, key) pairs a row may see."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kv, dim=2)
    qf = q.float() * (1.0 / math.sqrt(d))
    raw = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal and not bidirectional:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    mask = mask[None, None]
    if segment_ids is not None:
        seg_q, seg_k = segment_ids
        mask = mask & (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    return raw, _softcap(raw, softcap), mask


def attention_lse(q, k, v, *, causal=True, window=0, softcap=0.0,
                  segment_ids=None, bidirectional=False):
    """``attention_naive`` that also returns the row log-sum-exp
    (fp32 [B,H,Sq], in the scaled, softcapped logit domain): what the
    flash kernel's forward writes for its backward. A row with no valid
    key gets -inf (and output 0)."""
    h, kv = q.shape[2], k.shape[2]
    _, logits, mask = _attention_logits(
        q, k, causal=causal, window=window, softcap=softcap,
        segment_ids=segment_ids, bidirectional=bidirectional)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    p, m, l = _masked_softmax_weights(logits, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, -math.inf))
    return out.to(q.dtype), lse


def attention_naive(q, k, v, *, causal=True, window=0, softcap=0.0,
                    segment_ids=None, bidirectional=False):
    """q [B,Sq,H,D]; k,v [B,Skv,KV,D] -> [B,Sq,H,D]. fp32 math;
    causal masking is right-aligned (query i sits at i + Skv - Sq).
    ``segment_ids`` = (seg_q [B,Sq], seg_k [B,Skv]) integer ids: query
    row i sees key j only where seg_q[i] == seg_k[j] (packed sequences;
    cross-attention's valid source frames)."""
    return attention_lse(q, k, v, causal=causal, window=window,
                         softcap=softcap, segment_ids=segment_ids,
                         bidirectional=bidirectional)[0]


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True,
                            window=0, softcap=0.0, segment_ids=None,
                            bidirectional=False):
    """The gradient of ``attention_naive`` from its saved output and
    row log-sum-exp: P is recomputed from ``lse``, delta =
    rowsum(dout * out), dS = P * (dP - delta) times the softcap's
    derivative 1 - (s/cap)^2, and (dq, dk, dv) in the inputs' dtypes,
    dk and dv summed over each KV head's group of query heads. A row
    with no valid key (lse -inf, output 0) contributes nothing."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    _, logits, mask = _attention_logits(
        q, k, causal=causal, window=window, softcap=softcap,
        segment_ids=segment_ids, bidirectional=bidirectional)
    live = mask & torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(logits - lse[..., None]),
                    torch.zeros_like(logits))
    dof, vf = dout.float(), v.float().repeat_interleave(g, dim=2)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)      # [B,H,Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if softcap and softcap > 0.0:
        ds = ds * (1.0 - (logits / softcap) ** 2)
    kf = k.float().repeat_interleave(g, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, skv, kv, g, d).sum(3)
    dv = dv.reshape(b, skv, kv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tile_spans(ids, tile):
    """ids [B,S] -> [B, ceil(S/tile), 2]: the min and max id of each
    ``tile``-row tile, what the backward kernel's first launch writes
    for its tile skip."""
    b, s = ids.shape
    n = -(-s // tile)
    big = torch.iinfo(torch.int32).max
    pad = n * tile - s
    lo = torch.nn.functional.pad(ids, (0, pad), value=big)
    hi = torch.nn.functional.pad(ids, (0, pad), value=-big)
    return torch.stack([lo.reshape(b, n, tile).amin(-1),
                        hi.reshape(b, n, tile).amax(-1)], dim=-1)


def spans_meet(a, b):
    """Whether the [min, max] spans a [..., 2] and b [..., 2] overlap:
    the kernels' test of whether a (query tile, key tile) pair may hold
    a visible pair. Conservative for any ids: a pair with seg_q[i] ==
    seg_k[j] lies in both spans."""
    return torch.maximum(a[..., 0], b[..., 0]) <= \
        torch.minimum(a[..., 1], b[..., 1])


def _tile_key_range(r0, r1, sq, skv, tile, causal, window):
    """The key tiles a query tile [r0, r1) can see before the ids: the
    forward's skip of tiles past the causal frontier or below the
    window (right-aligned positions)."""
    q_off = skv - sq
    hi_pos = min(skv - 1, q_off + r1 - 1) if causal else skv - 1
    lo_pos = max(0, q_off + r0 - window + 1) if window > 0 else 0
    return range(lo_pos // tile, hi_pos // tile + 1 if hi_pos >= 0 else 0)


def _tile_query_range(c0, c1, sq, skv, tile, causal, window):
    """The query tiles a key tile [c0, c1) can be seen by before the
    ids: the dk/dv kernels' cut of the rows before the causal frontier
    or past the window (right-aligned positions)."""
    q_off = skv - sq
    i_lo = max(0, c0 - q_off) if causal else 0
    i_hi = min(sq - 1, c1 - 1 + window - 1 - q_off) if window > 0 \
        else sq - 1
    return range(i_lo // tile, i_hi // tile + 1 if i_lo <= i_hi else 0)


def fwd_tile_walk(sq, skv, tiles, *, causal=True, window=0,
                  segment_ids=None, bidirectional=False):
    """The forward kernels' walk: {(b, q tile, key tile)} -> True for
    each pair a q tile of ``tiles[0]`` rows walks over key tiles of
    ``tiles[1]`` rows: the causal / window key range
    (``_tile_key_range``), then with segment ids only the key tiles
    whose id span meets the q tile's (``tile_spans``, ``spans_meet``).
    Returns a bool [B, n q tiles, n key tiles] (B = 1 without ids)."""
    rows, walked = tiles
    causal = causal and not bidirectional
    nq, nk = -(-sq // rows), -(-skv // walked)
    b = 1 if segment_ids is None else segment_ids[0].shape[0]
    walk = torch.zeros((b, nq, nk), dtype=torch.bool)
    for qt in range(nq):
        keys = list(_tile_key_range(qt * rows, min(sq, (qt + 1) * rows), sq,
                                    skv, walked, causal, window))
        walk[:, qt, keys] = True
    if segment_ids is not None:
        walk &= spans_meet(
            tile_spans(segment_ids[0], rows)[:, :, None],
            tile_spans(segment_ids[1], walked)[:, None, :]).cpu()
    return walk


def flash_attention_fwd_blocked(q, k, v, *, causal=True, window=0,
                                softcap=0.0, segment_ids=None,
                                bidirectional=False, tiles=(64, 64)):
    """``attention_lse`` walked as the forward kernels walk it: each q
    tile of ``tiles[0]`` rows over the key tiles of ``tiles[1]`` rows
    that ``fwd_tile_walk`` keeps (the head_dim 16-128 bodies' (64, 64),
    the head_dim 256 body's (64, 32)), with an online softmax in f32:
    per tile m' = max(m, the tile's row max), alpha = exp(m - m'), l =
    alpha l + sum p, acc = alpha acc + p v; m starts at -1e30 and a
    masked logit is -inf, the kernels' values, so a walked tile whose
    entries are all masked adds p = 0 with alpha = 1. Returns (out in
    q's dtype, lse f32 [B,H,Sq], -inf for a row with no valid key, whose
    output is 0). Used by the tests and the kernel's host check: it
    holds the walk and the segment-span skip against the plain
    version."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    rows, walked = tiles
    causal = causal and not bidirectional
    qf = q.float() * (1.0 / math.sqrt(d))
    kf = k.float().repeat_interleave(h // kv, dim=2)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    kpos = torch.arange(skv, device=q.device)
    walk = fwd_tile_walk(sq, skv, tiles, causal=causal, window=window,
                         segment_ids=segment_ids)
    out = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sq), -math.inf, device=q.device)
    for bi in range(b):
        for qt in range(-(-sq // rows)):
            r0, r1 = qt * rows, min(sq, (qt + 1) * rows)
            m = torch.full((h, r1 - r0), NEG_INF, device=q.device)
            l = torch.zeros((h, r1 - r0), device=q.device)
            acc = torch.zeros((h, r1 - r0, d), device=q.device)
            for kt in walk[min(bi, walk.shape[0] - 1), qt].nonzero()[:, 0]:
                c0, c1 = int(kt) * walked, min(skv, (int(kt) + 1) * walked)
                qp, kp = qpos[r0:r1, None], kpos[None, c0:c1]
                mask = torch.ones((r1 - r0, c1 - c0), dtype=torch.bool,
                                  device=q.device)
                if causal:
                    mask &= kp <= qp
                if window and window > 0:
                    mask &= kp > qp - window
                if segment_ids is not None:
                    mask &= segment_ids[0][bi, r0:r1, None] == \
                        segment_ids[1][bi, None, c0:c1]
                x = _softcap(torch.einsum("qhd,khd->hqk", qf[bi, r0:r1],
                                          kf[bi, c0:c1]), softcap)
                x = torch.where(mask, x, torch.full_like(x, -math.inf))
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[..., None])
                l = alpha * l + p.sum(-1)
                acc = alpha[..., None] * acc + torch.einsum(
                    "hqk,khd->hqd", p, vf[bi, c0:c1])
                m = m_new
            out[bi, r0:r1] = (acc / l.clamp_min(1e-30)[..., None]) \
                .transpose(0, 1)
            lse[bi, :, r0:r1] = torch.where(
                l > 0, m + torch.log(l.clamp_min(1e-30)),
                torch.full_like(l, -math.inf))
    return out.to(q.dtype), lse


def flash_attention_bwd_blocked(q, k, v, out, lse, dout, *, causal=True,
                                window=0, softcap=0.0, segment_ids=None,
                                bidirectional=False, tiles=(64, 64)):
    """``flash_attention_bwd_ref`` walked as the backward kernels walk
    it. dq: each query tile of ``rows`` over the key tiles of
    ``walked`` inside its causal frontier and window; dk and dv: each
    key tile of ``rows`` over the query tiles of ``walked`` that can
    see it; with segment ids only the tile pairs whose id spans meet
    (``tile_spans``, ``spans_meet``). ``tiles`` = (rows, walked): the
    head_dim 16-128 bodies' dq walk (64, 64), the head_dim 256 bodies'
    (64, 32). Each pair recomputes its logits, P and dS from ``lse`` and
    adds into dq, or into dk and dv (f32 sums, dk and dv over each KV
    head's group). Used by the tests: it holds the tile walk and the
    skip against the reference."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    rows, walked = tiles
    scale = 1.0 / math.sqrt(d)
    causal = causal and not bidirectional
    qf, dof, of = q.float(), dout.float(), out.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    delta = (dof * of).sum(-1).transpose(1, 2)                 # [B,H,Sq]
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    kpos = torch.arange(skv, device=q.device)
    if segment_ids is not None:
        spans = {t: tuple(tile_spans(x, t) for x in segment_ids)
                 for t in {rows, walked}}

    def meet(bi, qt, q_tile, kt, k_tile):
        return segment_ids is None or bool(spans_meet(
            spans[q_tile][0][bi, qt], spans[k_tile][1][bi, kt]))

    def pair(bi, r0, r1, c0, c1):
        """(P, dS) [H, r1 - r0, c1 - c0] of one tile pair."""
        qp, kp = qpos[r0:r1, None], kpos[None, c0:c1]
        mask = torch.ones((r1 - r0, c1 - c0), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kp <= qp
        if window and window > 0:
            mask &= kp > qp - window
        if segment_ids is not None:
            mask &= segment_ids[0][bi, r0:r1, None] == \
                segment_ids[1][bi, None, c0:c1]
        lse_b = lse[bi, :, r0:r1, None].float()
        mask = mask[None] & torch.isfinite(lse_b)
        raw = torch.einsum("qhd,khd->hqk", qf[bi, r0:r1] * scale,
                           kf[bi, c0:c1])
        logits = _softcap(raw, softcap)
        p = torch.where(mask, torch.exp(logits - lse_b),
                        torch.zeros_like(logits))
        dp = torch.einsum("qhd,khd->hqk", dof[bi, r0:r1], vf[bi, c0:c1])
        ds = p * (dp - delta[bi, :, r0:r1, None])
        if softcap and softcap > 0.0:
            ds = ds * (1.0 - (logits / softcap) ** 2)
        return p, ds

    for bi in range(b):
        for qt in range(-(-sq // rows)):
            r0, r1 = qt * rows, min(sq, (qt + 1) * rows)
            for kt in _tile_key_range(r0, r1, sq, skv, walked, causal,
                                      window):
                if meet(bi, qt, rows, kt, walked):
                    c0, c1 = kt * walked, min(skv, (kt + 1) * walked)
                    _, ds = pair(bi, r0, r1, c0, c1)
                    dq[bi, r0:r1] += torch.einsum(
                        "hqk,khd->qhd", ds, kf[bi, c0:c1]) * scale
        for kt in range(-(-skv // rows)):
            c0, c1 = kt * rows, min(skv, (kt + 1) * rows)
            for qt in _tile_query_range(c0, c1, sq, skv, walked, causal,
                                        window):
                if meet(bi, qt, walked, kt, rows):
                    r0, r1 = qt * walked, min(sq, (qt + 1) * walked)
                    p, ds = pair(bi, r0, r1, c0, c1)
                    dk[bi, c0:c1] += torch.einsum(
                        "hqk,qhd->khd", ds, qf[bi, r0:r1]) * scale
                    dv[bi, c0:c1] += torch.einsum(
                        "hqk,qhd->khd", p, dof[bi, r0:r1])
    dk = dk.reshape(b, skv, kv, g, d).sum(3)
    dv = dv.reshape(b, skv, kv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
def _wide(t):
    """``t`` in float32, or float64 where it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def mamba_chunk_scan_naive(x, dt, A, B, C, D, *, chunk, initial_state=None):
    """Sequential-scan oracle for the Mamba2 SSD op (float32 math;
    float64 for float64 inputs, the gradient checks).

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
    xf, dtf, Bf, Cf, Af = (_wide(t) for t in (x, dt, B, C, A))
    state = (_wide(initial_state).clone() if initial_state is not None
             else torch.zeros((bt, h, p, n), dtype=xf.dtype,
                              device=x.device))
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * Af[None, :])                 # [Bt,H]
        state = state * da[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bt, 0, h, p))
    y = y + xf * _wide(D)[None, None, :, None]
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


def mamba_chunk_scan_bwd_ref(x, dt, A, B, C, D, dy, dfinal=None, *,
                             initial_state=None):
    """The gradient of ``mamba_chunk_scan_naive`` by torch autograd, in
    float32 on the inputs as given (a bf16 input is read as its f32
    value): the cotangents dy [Bt,S,H,P] of y and ``dfinal``
    [Bt,H,P,N] of the final state (None: zero) -> (dx, ddt, dA, dB, dC,
    dD, dinitial_state), all float32; dinitial_state is None when no
    initial state was given. Autograd keeps every token's state, ~4
    bytes x Bt H P N a token."""
    ins = [_wide(t).detach().requires_grad_(True)
           for t in (x, dt, A, B, C, D)]
    s0 = (None if initial_state is None else
          _wide(initial_state).detach().requires_grad_(True))
    with torch.enable_grad():
        y, fin = mamba_chunk_scan_naive(*ins, chunk=1, initial_state=s0)
        outs, cots = [y], [_wide(dy).to(y.dtype)]
        if dfinal is not None:
            outs.append(fin)
            cots.append(dfinal.to(fin.dtype))
        wrt = ins + ([s0] if s0 is not None else [])
        grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)]
    return tuple(grads[:6]) + (grads[6] if s0 is not None else None,)


SCAN_BWD_GROUP = 8     # heads a gradient block of the bf16 backward kernel


def mamba_chunk_scan_bwd_blocked(x, dt, A, B, C, D, dy, dfinal=None, *,
                                 initial_state=None, chunk=64):
    """``mamba_chunk_scan_bwd_ref`` in the backward kernel's arithmetic
    (float32), for the tests: S is cut into chunks of ``chunk`` tokens
    (rows past S are zero, dt = 0: decay 1, no input, no gradient). The
    default, 64, is the bf16 tensor-core body's chunk; the f32 first
    version walks chunks of 32, which changes the result only by
    rounding.
    With c_i the inclusive cumulative sum of the log-decays dt A inside a
    chunk, a chunk maps its entry state S0 to
      y_i   = e^{c_i} C_i S0^T + sum_{j<=i} e^{c_i-c_j} dt_j (C_i.B_j) x_j
              + D x_i,
      S_end = e^{c_L} S0 + T,  T = sum_j e^{c_L-c_j} dt_j x_j B_j^T.
    Three passes, as the kernel's launches (the chunked SSD form of
    arXiv:2405.21060 section 6 applied to the backward):
    1. chunk-local, every chunk at once: T_c and U_c = sum_i e^{c_i}
       dy_i^T C_i, the chunk's share of the adjoint;
    2. the passing, elementwise along the chunks: the state entering
       chunk c, S0_{c+1} = e^{c_L} S0_c + T_c from the initial state, and
       G_c = dL/dS_end of chunk c, G_{c-1} = e^{c_L} G_c + U_c from
       ``dfinal``; what G_{-1} reaches is dinitial_state;
    3. chunk-local gradients from S0_c and G_c: dx, the direct dt term,
       the gradient dc_i of each c_i (the off-diagonal term, the pairs
       j <= i as +row / -column sums, the chunk end's e^{c_L} <G, S0> and
       sum_j dt_j F_j) and its reverse cumulative sum dl (ddt += A dl, dA
       += sum dt dl); dB and dC summed over each group of
       SCAN_BWD_GROUP heads in head order, the weighted pairs A2 = w dt_j
       dy_i.x_j of a group summed before their products with B and C,
       then the groups in order (the kernel's partials and its
       fixed-order reduction).
    Pairs above the diagonal get weight 0 (never an exponential of a
    positive number). Returns what ``mamba_chunk_scan_bwd_ref``
    returns."""
    return scan_bwd_passes(x, dt, A, B, C, D, dy, dfinal,
                           initial_state=initial_state, chunk=chunk)


def _exact(operand, t):
    return t


def scan_bwd_passes(x, dt, A, B, C, D, dy, dfinal=None, *,
                    initial_state=None, chunk=64, made=_exact):
    """``mamba_chunk_scan_bwd_blocked``'s passes, each operand that the
    bf16 kernel makes in f32 passed through ``made(operand, t)`` before
    the product that takes it: "walk" (x_j e^{c_L-c_j} dt_j and dy_i
    e^{c_i}, into T_c and U_c), "states" (S0_c and G_c, into dy S0, x G
    and B G^T), "a1" (A1, into A1^T dy) and "a2" (a group's sum of A2,
    into A2 B and A2^T C). The identity by default; a rounding there
    emulates the kernel's operands (``tools/mamba_scan_bwd_rounding.py``)."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    ft = _wide(x).dtype                 # float32, float64 for float64
    q = chunk
    nc = max(1, -(-s // q))
    pad = nc * q - s
    dev = x.device

    def chunks(t):       # [bt, s, ...] -> [bt, nc, q, ...] in ft, zero pad
        t = t.to(ft)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bt, nc, q, *t.shape[2:])

    xc, dyc, dtc = chunks(x), chunks(dy), chunks(dt)    # [bt,nc,q,h(,p)]
    bc, cc = chunks(B), chunks(C)                       # [bt,nc,q,n]
    af = A.to(ft)
    ce = torch.cumsum(dtc * af, dim=2).transpose(2, 3)  # [bt,nc,h,q]
    dtj = dtc.transpose(2, 3)                           # [bt,nc,h,q]
    e_end = torch.exp(ce[..., -1:] - ce)                # e^{c_L - c_j}
    e_in = torch.exp(ce)                                # e^{c_i}
    e_last = torch.exp(ce[..., -1])                     # [bt,nc,h]

    # 1. chunk-local T_c and U_c
    xw = made("walk", xc * (e_end * dtj).transpose(2, 3)[..., None])
    dye = made("walk", dyc * e_in.transpose(2, 3)[..., None])
    t_loc = torch.einsum("bcjhp,bcjn->bchpn", xw, bc)
    u_loc = torch.einsum("bcihp,bcin->bchpn", dye, cc)
    # 2. the passing
    state = (initial_state.to(ft) if initial_state is not None else
             torch.zeros((bt, h, p, n), dtype=ft, device=dev))
    g = (dfinal.to(ft) if dfinal is not None else
         torch.zeros((bt, h, p, n), dtype=ft, device=dev))
    s0s, gs = [], [None] * nc
    for c in range(nc):
        s0s.append(state)
        state = e_last[:, c, :, None, None] * state + t_loc[:, c]
    for c in reversed(range(nc)):
        gs[c] = g
        g = e_last[:, c, :, None, None] * g + u_loc[:, c]
    s0 = torch.stack(s0s, 1)                            # [bt,nc,h,p,n]
    gc = torch.stack(gs, 1)
    # 3. chunk-local gradients
    idx = torch.arange(q, device=dev)
    lower = idx[:, None] >= idx[None, :]                # j <= i
    strict = idx[:, None] > idx[None, :]
    diff = torch.clamp(ce[..., :, None] - ce[..., None, :], max=0.0)
    wgt = torch.where(lower, torch.exp(diff), torch.zeros_like(diff))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)[:, :, None]
    dyx = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    a1 = wgt * cb                                       # dx's weights
    a2 = wgt * dtj[..., None, :] * dyx                  # dB's, dC's
    r = a1 * dyx                                        # direct dt terms
    m = torch.where(strict, r * dtj[..., None, :], torch.zeros_like(r))
    s0m, gm = made("states", s0), made("states", gc)
    gb = torch.einsum("bchpn,bcjn->bchjp", gm, bc)      # G B_j
    xg = torch.einsum("bcjhp,bchpn->bchjn", xc, gm)     # x_j^T G
    dys0 = torch.einsum("bcihp,bchpn->bchin", dyc, s0m)  # dy_i^T S0
    dx = (dtj[..., None] * (torch.einsum("bchij,bcihp->bchjp",
                                         made("a1", a1), dyc) +
                            e_end[..., None] * gb)).transpose(2, 3) + \
        dyc * D.to(ft)[None, None, None, :, None]
    f = e_end * torch.einsum("bcjhp,bchjp->bchj", xc, gb)
    direct = r.sum(3) + f                               # [bt,nc,h,q]
    off = e_in * torch.einsum("bchin,bcin->bchi", dys0, cc)
    dc = off + m.sum(4) - m.sum(3) - dtj * f
    dc[..., -1] += e_last * (gc * s0).sum((3, 4)) + (dtj * f).sum(3)
    dl = torch.flip(torch.cumsum(torch.flip(dc, [3]), 3), [3])
    ddt = (direct + af[None, None, :, None] * dl).transpose(2, 3)
    dA = (dtj * dl).sum((0, 1, 3))
    # dB, dC: each group of heads summed in head order, then the groups
    group = SCAN_BWD_GROUP
    ng = -(-h // group)
    hp = ng * group - h

    def grouped(t):      # [bt,nc,h,...] -> [bt,nc,ng,group,...], zero pad
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, hp))
        return t.reshape(bt, nc, ng, group, *t.shape[3:])
    a2g = made("a2", grouped(a2).sum(3))                # [bt,nc,ng,i,j]
    dc_part = grouped(e_in[..., None] * dys0).sum(3) + \
        torch.einsum("bcgij,bcjn->bcgin", a2g, bc)
    db_part = grouped((e_end * dtj)[..., None] * xg).sum(3) + \
        torch.einsum("bcgij,bcin->bcgjn", a2g, cc)
    dC, dB = dc_part.sum(2), db_part.sum(2)             # [bt,nc,q,n]
    dD = (dy.to(ft) * x.to(ft)).sum((0, 1, 3))

    def cut(t):
        return t.reshape(bt, nc * q, *t.shape[3:])[:, :s]
    return (cut(dx), cut(ddt), dA, cut(dB), cut(dC), dD,
            g if initial_state is not None else None)


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
