"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function here computes what its hand-written kernel computes, in
the same order of floating-point operations where that is cheap to say
in tensor code, so that on the card the two agree to rounding and on
the CPU the wrapper can run this version instead.
"""

from __future__ import annotations

import math

import torch

from repro_torch import prng


def subsample_stats_ref(data: torch.Tensor, indices: torch.Tensor, *,
                        rows_per_step: int = 8) -> torch.Tensor:
    """``data [B, N, D]`` fp32 + ``indices [B, T]`` int → ``[B, 2, D]`` fp32
    holding each task's ``(Σ_t row, Σ_t row²)`` over ``data[b, indices[b, t]]``.

    The order of summation is the kernel's: ``T`` is rounded up to a
    multiple of ``rows_per_step`` with the padded tail masked to zero; the
    rows of each group are added one after another into a group sum, and
    the group sums are added in index order into the accumulator.  Every
    square is rounded before it is added (no fused multiply-add)."""
    bsz, _, d = data.shape
    t = indices.shape[1]
    steps = -(-t // rows_per_step)
    t_pad = steps * rows_per_step
    idx = torch.zeros((bsz, t_pad), dtype=torch.int64, device=data.device)
    idx[:, :t] = indices.to(torch.int64)
    rows = data[torch.arange(bsz, device=data.device)[:, None], idx]
    valid = torch.arange(t_pad, device=data.device) < t
    rows = torch.where(valid[None, :, None], rows, torch.zeros_like(rows))
    groups = rows.view(bsz, steps, rows_per_step, d)
    gsum = torch.zeros((bsz, steps, d), dtype=torch.float32,
                       device=data.device)
    gsq = torch.zeros_like(gsum)
    for j in range(rows_per_step):
        r = groups[:, :, j]
        gsum = gsum + r
        gsq = gsq + r * r
    acc = torch.zeros((bsz, d), dtype=torch.float32, device=data.device)
    acc2 = torch.zeros_like(acc)
    for s in range(steps):
        acc = acc + gsum[:, s]
        acc2 = acc2 + gsq[:, s]
    return torch.stack([acc, acc2], dim=1)


def subsample_stats_seeded_ref(arena: torch.Tensor, rows: torch.Tensor,
                               seeds: torch.Tensor, *, n_idx: int,
                               rows_per_step: int = 8) -> torch.Tensor:
    """``subsample_stats_seeded``'s plain version: task ``b``'s indices are
    ``jax.random.randint(PRNGKey(seeds[b]), (n_idx,), 0, N)``
    (:func:`repro_torch.prng.randint`), then :func:`subsample_stats_ref`
    on the blocks ``arena[rows]`` → ``[B, 2, D]`` fp32."""
    idx = prng.randint(prng.PRNGKey(seeds), (n_idx,), 0, arena.shape[1])
    return subsample_stats_ref(arena[rows.long()], idx,
                               rows_per_step=rows_per_step)


def subsample_gather_ref(data: torch.Tensor, indices: torch.Tensor,
                         n_valid: torch.Tensor):
    """``data [N, D]`` (fp32 or bf16) + ``indices [T]`` int + ``n_valid
    [1]`` int → ``(gathered [T, D]`` in the data's type``, stats [2, D]``
    fp32``)``: ``gathered[t] = data[indices[t]]`` for every t, and stats =
    ``(Σ row, Σ row²)`` over the rows ``t < n_valid`` only, each widened to
    fp32.

    The order of summation is the kernel's: one row after another in t
    order into one fp32 accumulator, every square rounded before it is
    added (no fused multiply-add).  Reads ``n_valid`` on the host."""
    gathered = data[indices.to(torch.int64)]
    rows = gathered.float()
    n_rows = min(max(int(n_valid.reshape(-1)[0]), 0), rows.shape[0])
    acc = torch.zeros(data.shape[1], dtype=torch.float32, device=data.device)
    acc2 = torch.zeros_like(acc)
    for t in range(n_rows):                   # rows past n_valid: masked
        r = rows[t]
        acc = acc + r
        acc2 = acc2 + r * r
    return gathered, torch.stack([acc, acc2])


def grid_partial(data: torch.Tensor, months: torch.Tensor,
                 idx: torch.Tensor, *, grid: int,
                 statistic: str) -> torch.Tensor:
    """One task of ``subsample_grid``, the reference's
    ``core/subsample.py::map_task`` given its indices: ``data [ns, sl]``
    fp32, ``months [ns, sl]`` int32 (``monthly_mean`` only; else unread)
    and ``idx [draws, ns, draw_size]`` int in ``[0, sl)`` → ``[2, grid]``
    in ``data``'s type (fp32; float64 data gives the same cells with the
    scores and sums in float64, an oracle that the fp32 sums' order does
    not move).  Row 0 is the binned sum (``sum_curve`` / ``sum``), row 1 the
    bin counts (``hits`` / ``count``).

    ``alod`` bins position ``idx / sl`` at cell ``trunc(pos · grid)``, each
    an IEEE fp32 divide then multiply (divided by a tensor, never by a
    Python scalar, which PyTorch's CUDA path turns into a reciprocal
    product), and scores each observation ``|x − mean| / (std + 1e-6)``
    over its (sample, draw) row, std the population one.  The counts are
    whole numbers and exact; the sums are added in another order than the
    kernel's."""
    if statistic not in ("alod", "monthly_mean"):
        raise ValueError(f"unknown statistic {statistic!r}")
    draws, ns, ds = idx.shape
    sl = data.shape[1]
    idx_l = idx.to(torch.int64)
    gathered = torch.gather(data[None].expand(draws, ns, sl), 2, idx_l)
    gathered = gathered.transpose(0, 1)                  # [ns, draws, ds]
    if statistic == "alod":
        sl_t = torch.tensor(float(sl), dtype=torch.float32,
                            device=data.device)
        pos = idx.transpose(0, 1).to(torch.float32) / sl_t
        cell = (pos * grid).to(torch.int32).clamp(0, grid - 1)
        mean = gathered.mean(dim=2, keepdim=True)
        sd = gathered.std(dim=2, keepdim=True, correction=0) + 1e-6
        value = ((gathered - mean) / sd).abs()
    else:
        mo = torch.gather(months[None].expand(draws, ns, sl), 2, idx_l)
        cell = mo.transpose(0, 1).clamp(0, grid - 1)
        value = gathered
    cell = cell.reshape(-1).to(torch.int64)
    sums = torch.zeros(grid, dtype=data.dtype, device=data.device)
    sums.index_add_(0, cell, value.reshape(-1))
    counts = torch.bincount(cell, minlength=grid).to(data.dtype)
    return torch.stack([sums, counts])


def subsample_grid_ref(data: torch.Tensor, months: torch.Tensor,
                       rows: torch.Tensor, idx: torch.Tensor, *, grid: int,
                       statistic: str) -> torch.Tensor:
    """``subsample_grid``'s plain version: task ``b`` is arena slot
    ``rows[b]`` of ``data [n_slots, ns, sl]`` (and ``months``) with indices
    ``idx[b]`` ``[draws, ns, draw_size]`` → ``[B, 2, grid]`` fp32, one
    :func:`grid_partial` a task."""
    return torch.stack([
        grid_partial(data[r], months[r], idx[b], grid=grid,
                     statistic=statistic)
        for b, r in enumerate(rows.tolist())])


def subsample_grid_seeded_ref(data: torch.Tensor, months: torch.Tensor,
                              rows: torch.Tensor, seeds: torch.Tensor, *,
                              draws: int, draw_size: int, grid: int,
                              statistic: str) -> torch.Tensor:
    """``subsample_grid_seeded``'s plain version: task ``b``'s indices are
    ``jax.random.randint(PRNGKey(seeds[b]), (draws, ns, draw_size), 0,
    sl)`` (:func:`repro_torch.prng.randint`), then
    :func:`subsample_grid_ref` → ``[B, 2, grid]`` fp32."""
    _, ns, sl = data.shape
    idx = prng.randint(prng.PRNGKey(seeds), (draws, ns, draw_size), 0, sl)
    return subsample_grid_ref(data, months, rows, idx, grid=grid,
                              statistic=statistic)


def rwkv6_chunked_ref(r, k, v, logw, u) -> torch.Tensor:
    """Sequential (per-token) RWKV6 recurrence from a zero state;
    ``r, k, v, logw [B, H, S, hd]``, ``u [H, hd]`` → ``out [B, H, S, hd]``
    fp32.  The reference's ``ref.rwkv6_chunked_ref``."""
    b, h, s, hd = r.shape
    rf, kf, vf = (t.float() for t in (r, k, v))
    w = torch.exp(logw.float())
    uf = u.float()
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]     # [B,H,hdk,hdv]
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, :, t],
                                 state + uf[None, :, :, None] * kv))
        state = w[:, :, t, :, None] * state + kv
    return torch.stack(outs, dim=2)


def log_decay_sums(lw: torch.Tensor, dim: int):
    """A chunk's log-decay sums along ``dim``, formed as the kernels form
    them: a running sum in row order in ``lw``'s own precision (fp32 in
    fp32, float64 in float64), ``logP_i = run_i − logw_i`` and
    ``logP_{i+1} = logP_i + logw_i``.  Returns ``(logP_i, logP_{i+1})``.
    (``torch.cumsum`` on the CPU accumulates fp32 in double, which parts
    from the card's fp32 sums at large decays.)  On ``meta`` tensors,
    which carry shapes only (the dry run), one ``cumsum`` stands for the
    row loop."""
    if lw.is_meta:
        lp = torch.cumsum(lw, dim) - lw
        return lp, lp + lw
    run = torch.zeros_like(lw.select(dim, 0))
    sums = []
    for i in range(lw.shape[dim]):
        run = run + lw.select(dim, i)
        sums.append(run)
    lp = torch.stack(sums, dim=dim) - lw
    return lp, lp + lw


def chunk_body(r, k, v, logw, u, state):
    """One chunk of the RWKV6 recurrence in closed form: the reference's
    ``models/rwkv6.py::chunk_body``.  All inputs ``[B, H, C, hd]`` except
    ``u [H, hd]`` and ``state [B, H, hd, hd]`` fp32; every input is widened
    to fp32 first, as the kernel does.  Returns ``(out [B, H, C, hd] fp32,
    new_state)``.  Every pairwise decay exponent is ≤ 0, and the pairs
    ``j ≥ i`` are masked to ``-inf`` before the exponential."""
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    c = r.shape[2]
    # logP[i] = sum_{m<i} logw[m]  (exclusive cumsum, in row order)
    logp, logp_j1 = log_decay_sums(lw, 2)                         # [B,H,C,hd]
    logp_total = logp_j1[:, :, -1, :]                             # [B,H,hd]

    # inter-chunk: r_i ⊙ exp(logP_i) read the carried state
    inter = torch.einsum("bhid,bhde->bhie", rf * torch.exp(logp), state)

    # intra-chunk: A_ij = Σ_d r_i[d] k_j[d] exp(logP_i[d] − logP_{j+1}[d]), j<i
    dmat = logp[:, :, :, None, :] - logp_j1[:, :, None, :, :]     # [B,H,C,C,hd]
    idx = torch.arange(c, device=r.device)
    lower = idx[:, None] > idx[None, :]                           # strict
    dmat = torch.where(lower[None, None, :, :, None], dmat,
                       torch.full_like(dmat, float("-inf")))
    amat = torch.einsum("bhid,bhjd,bhijd->bhij", rf, kf, torch.exp(dmat))
    # diagonal bonus term: r_i · (u ⊙ k_i) v_i
    diag = torch.einsum("bhid,hd,bhid->bhi", rf, u.float(), kf)
    amat = amat + torch.eye(c, dtype=amat.dtype,
                            device=r.device)[None, None] * diag[..., None]
    intra = torch.einsum("bhij,bhje->bhie", amat, vf)

    # state update: S' = exp(logP_C) ⊙_k S + Σ_j (exp(logP_C−logP_{j+1}) ⊙ k_j) v_jᵀ
    k_dec = kf * torch.exp(logp_total[:, :, None, :] - logp_j1)
    new_state = (torch.exp(logp_total)[..., None] * state
                 + torch.einsum("bhjd,bhje->bhde", k_dec, vf))
    return inter + intra, new_state


def rwkv6_chunk_form_ref(r, k, v, logw, u, state, chunk: int, *,
                         with_states: bool = False):
    """The ``rwkv6_chunked`` kernel's plain version: :func:`chunk_body`
    chunk after chunk from ``state [B, H, hd, hd]`` fp32.  ``r, k, v, logw
    [B, H, S, hd]`` with ``S`` a multiple of ``chunk``; ``u [H, hd]``.
    Returns ``(out [B, H, S, hd] fp32, final_state [B, H, hd, hd] fp32)``;
    with ``with_states`` also the states entering every chunk but the
    first, ``[B, H, S / chunk − 1, hd, hd]`` fp32 (what the kernel's state
    pass writes, and its backward reads)."""
    s = r.shape[2]
    state = state.float()
    outs, entering = [], []
    for c0 in range(0, s, chunk):
        part = slice(c0, c0 + chunk)
        if c0:
            entering.append(state)
        out, state = chunk_body(r[:, :, part], k[:, :, part], v[:, :, part],
                                logw[:, :, part], u, state)
        outs.append(out)
    if not with_states:
        return torch.cat(outs, dim=2), state
    b, h, _, hd = r.shape
    states = (torch.stack(entering, dim=2) if entering else torch.empty(
        (b, h, 0, hd, hd), dtype=torch.float32, device=r.device))
    return torch.cat(outs, dim=2), state, states


def rwkv6_two_pass_ref(r, k, v, logw, u, state, chunk: int, sub: int = 16):
    """The arithmetic of the ``rwkv6_chunked`` CUDA kernel: the function of
    :func:`rwkv6_chunk_form_ref`, computed in the kernel's two passes.  The
    tests hold it against the chunk form and the reference; no path of the
    port calls it.

    1. The state pass: the state entering every chunk, chunk after chunk,
       ``S ← e^{logP_C} ⊙ S + (k ⊙ e^{logP_C − logP_{j+1}})ᵀ v``.
    2. The output pass, every chunk at once from its entering state:
       ``out = (r ⊙ e^{logP}) S_c + A v``, with A built in sub-chunks of
       ``sub`` rows.  A block I × J below the diagonal is the product
       ``(r_I ⊙ e^{logP_I − ref}) (k_J ⊙ e^{ref − logP_{j+1}})ᵀ``, ref the
       log decay at I's first row, so both exponents are ≤ 0.  A diagonal
       block is cut in halves the same way; its two diagonal halves stay
       pairwise, ``e^{logP_i − logP_{j+1}}`` for j < i, the bonus on the
       diagonal.

    The log-decay sums are formed as :func:`chunk_body` forms them.  Same
    arguments and result as :func:`rwkv6_chunk_form_ref`."""
    b, h, s, hd = r.shape
    n = s // chunk
    rf, kf, vf, lw = (t.float().reshape(b, h, n, chunk, hd)
                      for t in (r, k, v, logw))
    uf = u.float()
    lp, lq = log_decay_sums(lw, 3)                    # logP_i, logP_{j+1}
    total = lq[..., -1, :]                            # logP_C

    # 1. the state pass
    inc = torch.einsum("bhncd,bhnce->bhnde",
                       kf * torch.exp(total[..., None, :] - lq), vf)
    decay = torch.exp(total)
    entering = []
    st = state.float()
    for c in range(n):
        entering.append(st)
        st = decay[:, :, c, :, None] * st + inc[:, :, c]

    # 2. the output pass
    out = torch.einsum("bhncd,bhnde->bhnce", rf * torch.exp(lp),
                       torch.stack(entering, dim=2))

    def factored(i0, i1, j0, j1):       # rows [i0, i1) x columns [j0, j1)
        ref = lp[..., i0:i0 + 1, :]
        x = rf[..., i0:i1, :] * torch.exp(lp[..., i0:i1, :] - ref)
        y = kf[..., j0:j1, :] * torch.exp(ref - lq[..., j0:j1, :])
        return torch.einsum("bhnid,bhnjd->bhnij", x, y)

    def pairwise(i0, i1):               # rows and columns [i0, i1)
        dm = lp[..., i0:i1, None, :] - lq[..., None, i0:i1, :]
        idx = torch.arange(i1 - i0, device=r.device)
        lower = (idx[:, None] > idx[None, :])[..., None]
        e = torch.exp(torch.where(lower, dm, torch.full_like(dm, -math.inf)))
        blk = torch.einsum("bhnid,bhnjd,bhnijd->bhnij", rf[..., i0:i1, :],
                           kf[..., i0:i1, :], e)
        bonus = torch.einsum("bhnid,hd,bhnid->bhni", rf[..., i0:i1, :], uf,
                             kf[..., i0:i1, :])
        return blk + torch.diag_embed(bonus)

    a = torch.zeros((b, h, n, chunk, chunk), dtype=torch.float32,
                    device=r.device)
    for i0 in range(0, chunk, sub):
        i1 = min(i0 + sub, chunk)
        mid = min(i0 + sub // 2, i1)
        if i0 > 0:
            a[..., i0:i1, :i0] = factored(i0, i1, 0, i0)
        a[..., i0:mid, i0:mid] = pairwise(i0, mid)
        if mid < i1:
            a[..., mid:i1, i0:mid] = factored(mid, i1, i0, mid)
            a[..., mid:i1, mid:i1] = pairwise(mid, i1)
    out = out + torch.einsum("bhnij,bhnje->bhnie", a, vf)
    return out.reshape(b, h, s, hd), st


def rwkv6_chunked_bwd_ref(r, k, v, logw, u, state0, states, state_out, dout,
                          dstate_out, chunk: int):
    """The gradient of :func:`rwkv6_chunk_form_ref`, chunk by chunk, as the
    ``rwkv6_chunked_bwd`` kernel takes it: explicit formulas in fp32, not
    autograd.  ``states [B, H, S / chunk − 1, hd, hd]`` are the states
    entering every chunk but the first (what the forward's state pass
    writes), ``state_out`` the final state; ``dout [B, H, S, hd]`` and
    ``dstate_out [B, H, hd, hd]`` the gradients of the two outputs.

    With ``logP`` and ``logP_{j+1}`` a chunk's log-decay sums (formed as
    :func:`chunk_body` forms them), ``S_c`` the state entering chunk c,
    ``S'_c`` the one leaving it and ``dS'_c`` its gradient:

    1. The reverse state pass, from ``dS'_{n−1} = dstate_out``:
       ``dS_c = e^{logP_C} ⊙_rows dS'_c + (r ⊙ e^{logP})ᵀ dout``,
       ``dS'_{c−1} = dS_c``, ``dstate0 = dS_0``.
    2. Every chunk from its ``S_c``, ``S'_c`` and ``dS'_c``, with
       ``E_ij = e^{logP_i − logP_{j+1}}`` (j < i) and ``DP_ij = dout_i ·
       v_j``:
       ``dr'_i = e^{logP_i} ⊙ (S_c dout_i) + Σ_{j<i} DP_ij k_j ⊙ E_ij``,
       ``dk'_j = Σ_{i>j} DP_ij r_i ⊙ E_ij + e^{logP_C − logP_{j+1}} ⊙
       (dS'_c v_j)``,
       ``dr = dr' + u ⊙ k DP_ii``, ``dk = dk' + u ⊙ r DP_jj``,
       ``dv_j = Σ_{i≥j} A_ij dout_i + (k_j ⊙ e^{logP_C −
       logP_{j+1}})ᵀ dS'_c`` (A the forward's, bonus on its diagonal),
       ``du = Σ_{b, i} r_i ⊙ k_i DP_ii``.
    3. The log decays.  ``logw_m`` enters ``logP_i`` for i > m,
       ``logP_{j+1}`` for j ≥ m and ``logP_C``; every term that holds
       ``e^{logP_i}`` also holds ``r_i`` (so ``∂/∂logP_i = r_i ⊙ dr'_i``),
       every term with ``e^{−logP_{j+1}}`` holds ``k_j`` (``∂/∂logP_{j+1}
       = −k_j ⊙ dk'_j``), and ``S'_c`` is ``e^{logP_C}`` times the rest
       (``∂/∂logP_C = Σ_e dS'_c ⊙ S'_c``).  So
       ``dlogw_m = Σ_e dS'_c ⊙ S'_c + Σ_{i>m} r_i ⊙ dr'_i − Σ_{j≥m} k_j ⊙
       dk'_j``, within the chunk: no sum crosses a chunk.

    Every exponent is a difference ``later − earlier`` ≤ 0.  Returns ``(dr,
    dk, dv, dlogw, du, dstate0)``: dr, dk, dv and du in r's type, dlogw in
    logw's, dstate0 fp32.  Float64 inputs are taken in float64 throughout
    (the tests' oracle at extreme decays, where the fp32 log-decay sums'
    own rounding moves the gradients by some 1e-5)."""
    b, h, s, hd = r.shape
    n = s // chunk
    wide = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, lw, do = (t.to(wide).reshape(b, h, n, chunk, hd)
                          for t in (r, k, v, logw, dout))
    uf = u.to(wide)
    lp, lq = log_decay_sums(lw, 3)                    # logP_i, logP_{j+1}
    total = lq[..., -1, :]                            # logP_C
    entering = torch.cat([state0.to(wide)[:, :, None], states.to(wide)],
                         dim=2)
    leaving = torch.cat([states.to(wide), state_out.to(wide)[:, :, None]],
                        dim=2)

    # 1. the reverse state pass
    inc = torch.einsum("bhncd,bhnce->bhnde", rf * torch.exp(lp), do)
    decay = torch.exp(total)
    dleaving = [None] * n
    ds = dstate_out.to(wide)
    for c in range(n - 1, -1, -1):
        dleaving[c] = ds
        ds = decay[:, :, c, :, None] * ds + inc[:, :, c]
    dstate0 = ds
    dl = torch.stack(dleaving, dim=2)                 # dS'_c

    # 2. every chunk
    idx = torch.arange(chunk, device=r.device)
    lower = idx[:, None] > idx[None, :]                # i > j, strict
    dp = torch.einsum("bhnie,bhnje->bhnij", do, vf)
    diag = torch.diagonal(dp, dim1=3, dim2=4)          # DP_ii [b,h,n,C]
    dpl = dp * lower                                    # j < i only
    # k_j e^{logP_C − logP_{j+1}}
    kdec = kf * torch.exp(total[..., None, :] - lq)
    drp = torch.exp(lp) * torch.einsum("bhnde,bhnie->bhnid", entering, do)
    dkp = torch.exp(total[..., None, :] - lq) * torch.einsum(
        "bhnde,bhnje->bhnjd", dl, vf)
    amat = torch.zeros((b, h, n, chunk, chunk), dtype=wide, device=r.device)
    for c in range(n):          # one chunk's [B, H, C, C, hd] at a time
        dm = lp[:, :, c, :, None, :] - lq[:, :, c, None, :, :]
        e = torch.exp(torch.where(lower[..., None], dm,
                                  torch.full_like(dm, -math.inf)))
        drp[:, :, c] += torch.einsum("bhij,bhjd,bhijd->bhid", dpl[:, :, c],
                                     kf[:, :, c], e)
        dkp[:, :, c] += torch.einsum("bhij,bhid,bhijd->bhjd", dpl[:, :, c],
                                     rf[:, :, c], e)
        amat[:, :, c] = torch.einsum("bhid,bhjd,bhijd->bhij", rf[:, :, c],
                                     kf[:, :, c], e)
    bonus = torch.einsum("bhnid,hd,bhnid->bhni", rf, uf, kf)
    amat = amat + torch.diag_embed(bonus)
    dr = drp + uf[None, :, None, None] * kf * diag[..., None]
    dk = dkp + uf[None, :, None, None] * rf * diag[..., None]
    dv = (torch.einsum("bhnij,bhnie->bhnje", amat, do)
          + torch.einsum("bhnjd,bhnde->bhnje", kdec, dl))
    du = torch.einsum("bhnid,bhnid,bhni->hd", rf, kf, diag)

    # 3. the log decays, within each chunk
    x = rf * drp
    y = kf * dkp
    after_x = torch.flip(torch.cumsum(torch.flip(x, [3]), dim=3), [3]) - x
    from_y = torch.flip(torch.cumsum(torch.flip(y, [3]), dim=3), [3])
    tail = (dl * leaving).sum(dim=-1)                  # Σ_e dS'_c ⊙ S'_c
    dlogw = tail[..., None, :] + after_x - from_y

    def back(t, like):
        return t.reshape(b, h, s, hd).to(like.dtype)

    return (back(dr, r), back(dk, k), back(dv, v), back(dlogw, logw),
            du.to(u.dtype), dstate0)


def rwkv6_chunked_bwd_factored_ref(r, k, v, logw, u, state0, states,
                                   state_out, dout, dstate_out, chunk: int,
                                   sub: int = 16, product=torch.matmul):
    """The arithmetic of the ``rwkv6_chunked_bwd`` CUDA kernel: the
    function of :func:`rwkv6_chunked_bwd_ref` (same arguments, same
    result), with every pairwise decay outside the diagonal blocks
    factored so that the sums become matrix products.  The tests hold it
    against the plain backward and the reference; no path of the port
    calls it.  ``product(a, b)`` is ``a @ b`` over the last two dimensions
    (a test may round its operands as the tensor cores do).

    The chunk is cut into blocks of ``sub`` rows.  For block I with
    ``ref_I = logP`` at its first row and ``ref'_I = logP_{j+1}`` at its
    last row, every exponent below is ``later − earlier`` ≤ 0:

    * ``dr'_I = e^{logP_I − ref_I} ⊙ [dout_I (S_c ⊙_rows e^{ref_I})ᵀ +
      DP_{I,<I} (k_{<I} ⊙ e^{ref_I − logP_{<I,j+1}})]``;
    * ``dk'_I = e^{ref'_I − logP_{I,j+1}} ⊙ [v_I (dS'_c ⊙_rows e^{logP_C −
      ref'_I})ᵀ + DP_{>I,I}ᵀ R'_{>I}]`` with ``R'_i = r_i ⊙ e^{logP_i −
      ref'_I}``;
    * ``A_{>I,I} = R'_{>I} K'_Iᵀ`` with ``K'_I = k_I ⊙ e^{ref'_I −
      logP_{I,j+1}}``, and dv's state term from ``k̃_I = K'_I ⊙
      e^{logP_C − ref'_I}``;
    * the diagonal block is cut at its middle row m: its lower-left part
      is factored at ``ref8 = logP_m`` (``r ⊙ e^{logP_i − ref8}``, ``k ⊙
      e^{ref8 − logP_{j+1}}``) for A, dr' and dk' alike; its two diagonal
      halves keep the pairwise ``e^{logP_i − logP_{j+1}}`` (j < i), the
      bonus on A's diagonal.

    The reverse state pass is the plain version's, its product through
    ``product``.  dlogw is summed as the kernel sums it: from the chunk's
    last row up, ``run = tail``, then ``run −= y_m``, ``dlogw_m = run``,
    ``run += x_m``."""
    b, h, s, hd = r.shape
    n = s // chunk
    wide = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, lw, do = (t.to(wide).reshape(b, h, n, chunk, hd)
                          for t in (r, k, v, logw, dout))
    uf = u.to(wide)
    lp, lq = log_decay_sums(lw, 3)                    # logP_i, logP_{j+1}
    total = lq[..., -1:, :]                           # logP_C [.., 1, hd]
    entering = torch.cat([state0.to(wide)[:, :, None], states.to(wide)],
                         dim=2)
    leaving = torch.cat([states.to(wide), state_out.to(wide)[:, :, None]],
                        dim=2)
    ex = torch.exp

    def tr(t):
        return t.transpose(-1, -2)

    # 1. the reverse state pass: dS_c = e^{logP_C} ⊙_rows dS'_c + r̃ᵀ dout
    inc = product(tr(rf * ex(lp)), do)
    decay = tr(ex(total))                             # [.., hd, 1]
    dleaving = [None] * n
    ds = dstate_out.to(wide)
    for c in range(n - 1, -1, -1):
        dleaving[c] = ds
        ds = decay[:, :, c] * ds + inc[:, :, c]
    dstate0 = ds
    dl = torch.stack(dleaving, dim=2)                 # dS'_c

    # 2. every chunk, block by block
    dp = product(do, tr(vf))                          # DP_ij
    drp, dkp, kdec = (torch.zeros_like(rf) for _ in range(3))
    amat = torch.zeros((b, h, n, chunk, chunk), dtype=wide, device=r.device)
    for i0 in range(0, chunk, sub):
        i1 = min(i0 + sub, chunk)
        mid = min(i0 + sub // 2, i1)
        ref, refp = lp[..., i0:i0 + 1, :], lq[..., i1 - 1:i1, :]
        acc = product(do[..., i0:i1, :], tr(entering * tr(ex(ref))))
        if i0:
            khat = kf[..., :i0, :] * ex(ref - lq[..., :i0, :])
            acc = acc + product(dp[..., i0:i1, :i0], khat)
        drp[..., i0:i1, :] = ex(lp[..., i0:i1, :] - ref) * acc
        acc = product(vf[..., i0:i1, :], tr(dl * tr(ex(total - refp))))
        kt = kf[..., i0:i1, :] * ex(refp - lq[..., i0:i1, :])
        if i1 < chunk:
            rt = rf[..., i1:, :] * ex(lp[..., i1:, :] - refp)
            acc = acc + product(tr(dp[..., i1:, i0:i1]), rt)
            amat[..., i1:, i0:i1] = product(rt, tr(kt))
        dkp[..., i0:i1, :] = ex(refp - lq[..., i0:i1, :]) * acc
        kdec[..., i0:i1, :] = kt * ex(total - refp)
        # the diagonal block: its lower-left part factored at ref8
        if mid < i1:
            ref8 = lp[..., mid:mid + 1, :]
            e8 = ex(lp[..., mid:i1, :] - ref8)
            q8 = ex(ref8 - lq[..., i0:mid, :])
            r8, k8 = rf[..., mid:i1, :] * e8, kf[..., i0:mid, :] * q8
            f = dp[..., mid:i1, i0:mid]
            drp[..., mid:i1, :] += e8 * product(f, k8)
            dkp[..., i0:mid, :] += q8 * product(tr(f), r8)
            amat[..., mid:i1, i0:mid] = product(r8, tr(k8))
        # its two diagonal halves, pairwise
        for p0, p1 in ((i0, mid), (mid, i1)):
            if p0 == p1:
                continue
            dm = lp[..., p0:p1, None, :] - lq[..., None, p0:p1, :]
            idx = torch.arange(p1 - p0, device=r.device)
            lower = (idx[:, None] > idx[None, :])[..., None]
            e = ex(torch.where(lower, dm, torch.full_like(dm, -math.inf)))
            blk = dp[..., p0:p1, p0:p1]
            drp[..., p0:p1, :] += torch.einsum("bhnij,bhnjd,bhnijd->bhnid",
                                               blk, kf[..., p0:p1, :], e)
            dkp[..., p0:p1, :] += torch.einsum("bhnij,bhnid,bhnijd->bhnjd",
                                               blk, rf[..., p0:p1, :], e)
            amat[..., p0:p1, p0:p1] = torch.einsum(
                "bhnid,bhnjd,bhnijd->bhnij", rf[..., p0:p1, :],
                kf[..., p0:p1, :], e)
    diag = torch.diagonal(dp, dim1=3, dim2=4)          # DP_ii
    bonus = torch.einsum("bhnid,hd,bhnid->bhni", rf, uf, kf)
    amat = amat + torch.diag_embed(bonus)
    dr = drp + uf[None, :, None, None] * kf * diag[..., None]
    dk = dkp + uf[None, :, None, None] * rf * diag[..., None]
    dv = product(tr(amat), do) + product(kdec, dl)
    du = torch.einsum("bhnid,bhnid,bhni->hd", rf, kf, diag)

    # 3. the log decays, within each chunk, from its last row up
    x, y = rf * drp, kf * dkp
    run = (dl * leaving).sum(dim=-1)                   # Σ_e dS'_c ⊙ S'_c
    dlogw = torch.empty_like(x)
    for m in range(chunk - 1, -1, -1):
        run = run - y[..., m, :]
        dlogw[..., m, :] = run
        run = run + x[..., m, :]

    def back(t, like):
        return t.reshape(b, h, s, hd).to(like.dtype)

    return (back(dr, r), back(dk, k), back(dv, v), back(dlogw, logw),
            du.to(u.dtype), dstate0)


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t ⊙ h_{t−1} + b_t`` from ``h_{−1} = h0``, one step after
    another in fp32: ``a, b [B, S, W]``, ``h0 [B, W]`` → ``[B, S, W]`` fp32.
    Each step rounds the product before the sum, as the ``rglru_scan``
    kernel does, so the two agree bit for bit.  The reference's
    ``ref.linear_scan_ref`` computes the same recurrence as an associative
    scan, whose other order of operations agrees to rounding.  On ``meta``
    tensors (shapes only: the dry run) no step is taken."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty_like(af)
    for t in range(0 if out.is_meta else af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out


def rglru_gates(u: torch.Tensor, gate_a_w: torch.Tensor,
                gate_a_b: torch.Tensor, gate_x_w: torch.Tensor,
                gate_x_b: torch.Tensor, softplus_lam: torch.Tensor):
    """The RG-LRU's decay ``a`` and gated input ``b`` from the block's
    post-conv input ``u [B, S, W]``: the gate vectors ``[W]`` (fp32 or
    bf16) and ``softplus_lam = softplus(lam) [W]`` fp32 → ``(a, b)`` fp32
    ``[B, S, W]``.  These torch ops, in this order, are what the gated form
    of the ``rglru_scan`` kernel computes element by element."""
    uf = u.float()
    r = torch.sigmoid(gate_a_w * uf + gate_a_b)
    i = torch.sigmoid(gate_x_w * uf + gate_x_b)
    a = torch.exp(-8.0 * r * softplus_lam)     # Griffin's c = 8
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-6)) * (i * uf)
    return a, gated


def rglru_gated_scan_ref(u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                         softplus_lam, h0) -> torch.Tensor:
    """:func:`rglru_gates`, then :func:`linear_scan_ref` from ``h0 [B,
    W]``: the RG-LRU's hidden states ``[B, S, W]`` fp32."""
    a, gated = rglru_gates(u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                           softplus_lam)
    return linear_scan_ref(a, gated, h0)


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                       dh: torch.Tensor):
    """The gradient of :func:`linear_scan_ref` from its decay ``a``, its
    output ``h``, ``h0`` and the output's gradient ``dh`` (all fp32 ``[B,
    S, W]``, ``h0 [B, W]``): the reverse scan ``g_t = dh_t + a_{t+1} ⊙
    g_{t+1}`` (``g_{S−1} = dh_{S−1}``), one step after another, each
    product rounded before the sum as the ``rglru_scan_bwd`` kernel takes
    it, then ``da_t = g_t ⊙ h_{t−1}`` (``h_{−1} = h0``), ``db_t = g_t``
    and ``dh0 = a_0 ⊙ g_0``.  Returns ``(da, db, dh0)`` fp32.  On ``meta``
    tensors (shapes only: the dry run) no step is taken."""
    af, dhf = a.float(), dh.float()
    g = torch.empty_like(dhf)
    acc = dhf[:, -1]
    g[:, -1] = acc
    for t in range(-1 if g.is_meta else af.shape[1] - 2, -1, -1):
        acc = dhf[:, t] + af[:, t + 1] * acc
        g[:, t] = acc
    hprev = torch.cat([h0.float()[:, None], h.float()[:, :-1]], dim=1)
    return g * hprev, g, af[:, 0] * g[:, 0]


def rglru_gated_scan_bwd_ref(u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                             softplus_lam, h0, h, dh):
    """The gradient of :func:`rglru_gated_scan_ref` from its inputs, its
    output ``h`` and the output's gradient ``dh [B, S, W]`` fp32:
    :func:`rglru_gates` formed again, :func:`rglru_scan_bwd_ref`, then the
    chain rule back through the gates, op by op:

        d√ = db ⊙ (i u),  d(i u) = db ⊙ √keep,
        dkeep = d√ ⊙ 0.5 / √keep   where 1 − a² ≥ 1e-6 (the clamp passes
                                     no gradient where it binds),
        dlog_a = (da − 2 a ⊙ dkeep) ⊙ a,
        dr = dlog_a ⊙ softplus_lam ⊙ (−8),   dsp = Σ dlog_a ⊙ (−8 r),
        dz_a = dr ⊙ r (1 − r),   dz_x = d(i u) ⊙ u ⊙ i (1 − i),
        du = dz_a ⊙ w_a + dz_x ⊙ w_x + d(i u) ⊙ i,
        dw_a = Σ dz_a ⊙ u,  db_a = Σ dz_a,  dw_x = Σ dz_x ⊙ u,  db_x = Σ dz_x,

    the sums over B and S.  Returns ``(du, dw_a, db_a, dw_x, db_x,
    dsoftplus_lam, dh0)``: du in u's type, the gate vectors' gradients in
    theirs, the last two fp32."""
    du, terms, dh0 = _rglru_gated_bwd_terms(
        u, gate_a_w, gate_a_b, gate_x_w, gate_x_b, softplus_lam, h0, h, dh)
    return _rglru_gated_bwd_out(u, (gate_a_w, gate_a_b, gate_x_w, gate_x_b),
                                du, [t.sum((0, 1)) for t in terms], dh0)


def rglru_gated_scan_bwd_kernel_order_ref(u, gate_a_w, gate_a_b, gate_x_w,
                                          gate_x_b, softplus_lam, h0, h, dh):
    """:func:`rglru_gated_scan_bwd_ref` with the five sums added in the
    ``rglru_scan_bwd`` kernel's order (its source's header): row ``t0 + s +
    32 j`` of a 64-step chunk belongs to slot ``s`` of 32; a slot's fp32 sum
    adds its rows to 0 chunk by chunk from the last chunk, ``j = 0, 1`` in
    order within one; a channel's partial adds its 32 slots to 0 in order;
    the batch rows' partials add to 0 in order.  du and dh0 are the plain
    version's; on the card the sums equal the kernel's bit for bit."""
    du, terms, dh0 = _rglru_gated_bwd_terms(
        u, gate_a_w, gate_a_b, gate_x_w, gate_x_b, softplus_lam, h0, h, dh)
    return _rglru_gated_bwd_out(u, (gate_a_w, gate_a_b, gate_x_w, gate_x_b),
                                du, [_kernel_order_sum(t) for t in terms],
                                dh0)


def _rglru_gated_bwd_terms(u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                           softplus_lam, h0, h, dh):
    """du (fp32), the five fp32 terms ``[B, S, W]`` the gate vectors' sums
    take (dz_a u, dz_a, dz_x u, dz_x, dlog_a (−8 r)) and dh0, each element
    by the chain rule of :func:`rglru_gated_scan_bwd_ref`."""
    uf = u.float()
    sp = softplus_lam.float()
    r = torch.sigmoid(gate_a_w * uf + gate_a_b)
    i = torch.sigmoid(gate_x_w * uf + gate_x_b)
    a = torch.exp(-8.0 * r * sp)
    keep = 1.0 - torch.square(a)
    root = torch.sqrt(torch.clamp(keep, min=1e-6))
    iu = i * uf
    da, db, dh0 = rglru_scan_bwd_ref(a, h, h0, dh)
    dkeep = torch.where(keep >= 1e-6, db * iu * (0.5 / root),
                        torch.zeros_like(db))
    dlog_a = (da - 2.0 * a * dkeep) * a
    dr = dlog_a * sp * -8.0
    diu = db * root
    dza = dr * (r * (1.0 - r))
    dzx = diu * uf * (i * (1.0 - i))
    du = dza * gate_a_w.float() + dzx * gate_x_w.float() + diu * i
    return du, (dza * uf, dza, dzx * uf, dzx, dlog_a * (-8.0 * r)), dh0


def _rglru_gated_bwd_out(u, gates, du, sums, dh0):
    return (du.to(u.dtype),
            *(t.to(g.dtype) for t, g in zip(sums, gates)), sums[4], dh0)


RGLRU_BWD_CHUNK = 64             # the kernel's steps a chunk
RGLRU_BWD_SLOTS = 32             # its row slots a chunk


def _kernel_order_sum(t: torch.Tensor) -> torch.Tensor:
    """``t [B, S, W]`` fp32 summed over B and S in the kernel's order (see
    :func:`rglru_gated_scan_bwd_kernel_order_ref`).  Rows past S are added
    as +0, which leaves a sum started at +0 unchanged, as the kernel's
    skipping them does."""
    b, s, w = t.shape
    chunks = -(-s // RGLRU_BWD_CHUNK)
    padded = torch.zeros((b, chunks * RGLRU_BWD_CHUNK, w),
                         dtype=torch.float32, device=t.device)
    padded[:, :s] = t
    rows = padded.view(b, chunks, RGLRU_BWD_CHUNK // RGLRU_BWD_SLOTS,
                       RGLRU_BWD_SLOTS, w)
    slots = torch.zeros((b, RGLRU_BWD_SLOTS, w), dtype=torch.float32,
                        device=t.device)
    for k in range(chunks - 1, -1, -1):
        for j in range(rows.shape[2]):
            slots = slots + rows[:, k, j]
    part = torch.zeros((b, w), dtype=torch.float32, device=t.device)
    for sl in range(RGLRU_BWD_SLOTS):
        part = part + slots[:, sl]
    total = torch.zeros((w,), dtype=torch.float32, device=t.device)
    for bi in range(b):
        total = total + part[bi]
    return total


def attention_mask(sq: int, skv: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """``[Sq, Skv]`` bool: key ``j`` is seen by query ``i`` when
    ``j <= i`` (if causal) and ``i − j < window`` (if ``window`` > 0)."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window:
        mask &= (i - j) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        group: int = 1) -> torch.Tensor:
    """Plain masked softmax attention in fp32: ``q [BH, Sq, HD]``, ``k, v
    [BH / group, Skv, HD]`` → ``[BH, Sq, HD]`` in q's type.  Query head
    ``bh`` reads key/value head ``bh // group``; the mask is
    :func:`attention_mask`, applied as a score of −1e30 (the reference's
    ``ref.flash_attention_ref``).  A query row that sees no key at all
    (only when ``Sq > Skv + window − 1``) gives zeros, as the kernel does,
    where a −1e30 row would average every value."""
    _, sq, hd = q.shape
    skv = k.shape[1]
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bid,bjd->bij", q.float(), kf) * scale
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1) * mask.any(dim=1)[None, :, None]
    return torch.einsum("bij,bjd->bid", p, vf).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            group: int = 1) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores in fp32:
    ``[BH, Sq]``, −inf for a row that sees no key (what the
    ``flash_attention`` kernel writes beside its output for training)."""
    _, sq, hd = q.shape
    skv = k.shape[1]
    kf = k.float().repeat_interleave(group, dim=0)
    s = torch.einsum("bid,bjd->bij", q.float(), kf) * (1.0 / math.sqrt(hd))
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask[None], s, torch.full_like(s, float("-inf")))
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            group: int = 1):
    """The attention backward from the forward's output and log-sum-exp,
    the explicit formulas in fp32 (FlashAttention-2's):

        D_i = Σ_d dout_id out_id,   P_ij = exp(scale · q_i·k_j − lse_i),
        dS_ij = P_ij (dout_i·v_j − D_i),
        dq = scale · dS k,  dk = scale · dSᵀ q,  dv = Pᵀ dout,

    ``P`` zero where :func:`attention_mask` hides a key or the row sees
    none (``lse`` = −inf); a key/value head's ``dk`` and ``dv`` sum its
    group of query heads in fp32.  Returns ``(dq, dk, dv)`` in the inputs'
    types."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf, of, dof = q.float(), out.float(), dout.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    lsef = lse.float()
    seen = mask[None] & torch.isfinite(lsef)[:, :, None]
    s = torch.einsum("bid,bjd->bij", qf, kf) * scale
    p = torch.where(seen, torch.exp(s - torch.where(
        torch.isfinite(lsef), lsef, torch.zeros_like(lsef))[:, :, None]),
        torch.zeros_like(s))
    delta = (dof * of).sum(dim=-1)
    dp = torch.einsum("bid,bjd->bij", dof, vf)
    ds = p * (dp - delta[:, :, None])
    dq = torch.einsum("bij,bjd->bid", ds, kf) * scale
    dk = torch.einsum("bij,bid->bjd", ds, qf) * scale
    dv = torch.einsum("bij,bid->bjd", p, dof)
    dk = dk.view(bh // group, group, skv, hd).sum(dim=1)
    dv = dv.view(bh // group, group, skv, hd).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_decode_int8_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, cache, pos: int, *,
                              window: int = 0):
    """One decode step over an int8 cache, as torch ops: ``q [B, 1, KV, G,
    HD]`` and the new token's ``k, v [B, 1, KV, HD]`` (after RoPE), the
    cache ``{k, v [B, S_max, KV, HD] int8, k_scale, v_scale [B, S_max, KV,
    1] fp32}`` → ``(out [B, KV, G, HD]`` in v's type, the new cache``)``.
    The new token is quantized and written at ``pos`` (``pos % window`` in
    a rolling buffer) into a copy of the cache, the whole copy dequantized
    to the token's type, and the slots past the write are masked until the
    buffer has wrapped; the probabilities are rounded to v's type before
    the product with v.  The ``attention_decode_int8`` kernel computes the
    same from the int8 values where they lie."""
    # the cache format is the model layer's (imported here: it imports ops)
    from repro_torch.models.layers import dequantize_kv, quantize_kv

    s_max = cache["k"].shape[1]
    write_at = pos % window if window else pos
    new_cache = {n: t.clone() for n, t in cache.items()}
    for n, t in (("k", k), ("v", v)):
        vals, absmax = quantize_kv(t)
        new_cache[n][:, write_at] = vals[:, 0]
        new_cache[n + "_scale"][:, write_at] = absmax[:, 0]
    ck = dequantize_kv(new_cache["k"], new_cache["k_scale"], k.dtype)
    cv = dequantize_kv(new_cache["v"], new_cache["v_scale"], v.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bikgd,bjkd->bkgj", q.float(), ck.float()) * scale
    slot = torch.arange(s_max, device=q.device)
    if window:
        valid = (slot <= write_at) | (pos >= window)
    else:
        valid = slot <= pos
    scores = torch.where(valid[None, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", probs.to(cv.dtype), cv)
    return out, new_cache
