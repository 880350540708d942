"""Top-k MoE layer with capacity-bounded token dropping (the port of
``repro.models.transformer.moe``).

The reference dispatches and combines through dense one-hot einsums over
``[tokens, experts, capacity]`` and runs the experts as einsums, all
outside any Pallas kernel.  Here every kept ``(token, choice)`` goes to its
``(expert, slot)`` row by an index copy, the experts are batched matrix
products over ``[E, C, D]``, and each token gathers its kept outputs back:
the same function, since each slot holds at most one token and each
token's choices name distinct experts.  Empty slots are zero rows, as the
one-hot dispatch leaves them.

:func:`moe_apply_mesh` is the same function over a mesh, laid out as the
reference's ``shard.act`` calls lay it out: the experts over "model", and
the capacity over the data axes where it reaches 1,024 slots.  Each data
group routes its own tokens (gathering the choices of the tokens it
shares a dispatch with), scatters them into capacity buffers, and the
buffers' slots move to the positions that hold them and back by
all-to-all; each position sums its experts' share of a token in float32
and an all-reduce over "model" adds the shares.  Every shape is static,
so the dry-run traces it on ``meta``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...distributed.collectives import axis_groups, psum
from ...distributed.observe import at_position
from ...distributed.sharding import send, shard_bounds
from ..common import Split, dense_init

__all__ = ["MoERoute", "init_moe", "moe_route", "moe_apply", "moe_apply_mesh",
           "moe_param_specs", "MOE_KEYS", "SLAB"]

MOE_KEYS = ("w_router", "wi", "wg", "wo")
# tokens per dispatch when a long input splits into slabs (the reference's
# ``moe_apply(..., slab=8192)``)
SLAB = 8192


def moe_param_specs() -> dict:
    """Logical axes of one MoE layer's parameters (the reference's
    ``moe_param_specs``): the experts over "model", the router
    replicated."""
    return {
        "w_router": (None, None),
        "wi": ("model", None, None),
        "wg": ("model", None, None),
        "wo": ("model", None, None),
    }


class MoERoute(NamedTuple):
    """The routing of ``T`` tokens: each token's ``k`` experts in
    descending probability (ties to the lower index, as ``jax.lax.top_k``),
    their normalised gates, each choice's place in its expert's queue
    (counted in ``(token, choice)`` order), whether it is within the
    capacity, the capacity, and the Switch balance term."""

    gate_idx: torch.Tensor      # [T, k] int64
    gate_vals: torch.Tensor     # [T, k] float32
    pos: torch.Tensor           # [T, k] int64
    keep: torch.Tensor          # [T, k] bool
    cap: int
    aux: torch.Tensor           # [] float32


def init_moe(gen: torch.Generator, d_model: int, moe,
             dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """A layer's MoE parameters with the reference's distributions: the
    router ``N(0, 1/d_model)`` in float32, each expert's ``wi``, ``wg``
    ``[E, d_model, d_ff]`` ``N(0, 1/d_model)`` and ``wo`` ``[E, d_ff,
    d_model]`` ``N(0, 1/d_ff)`` in ``dtype``.  Drawn in float32 on the
    generator's device and scaled in place (a full-width expert stack is
    gigabytes)."""
    ks = Split(gen)
    e, dff = moe.n_experts, moe.d_ff_expert

    def experts(shape, fan_in):
        w = torch.randn(shape, generator=ks(), device=gen.device)
        return w.mul_(1.0 / fan_in ** 0.5).to(dtype)

    return {
        "w_router": dense_init(ks(), d_model, e, dtype=torch.float32),
        "wi": experts((e, d_model, dff), d_model),
        "wg": experts((e, d_model, dff), d_model),
        "wo": experts((e, dff, d_model), dff),
    }


def moe_route(p, x: torch.Tensor, moe) -> MoERoute:
    """Route ``x [T, D]`` as one dispatch: float32 router logits
    ``x @ w_router`` and their softmax, the top ``k`` by a stable
    descending sort, gates normalised by ``max(sum, 1e-9)``, the capacity
    ``max(int(capacity_factor * k * T / E + 0.5), 1)`` and each choice's
    queue position by a running count per expert over the ``T * k``
    choices, token major."""
    t = x.shape[0]
    e = moe.n_experts
    cap = _capacity(t, moe)
    probs, gate_vals, gate_idx = _gates(p.w_router, x, moe)
    # Switch balance term on the first choice: E * sum_e f_e * P_e
    fe = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(fe * probs.mean(dim=0))
    pos = _queue(gate_idx[None], e)[0]
    return MoERoute(gate_idx, gate_vals, pos, pos < cap, cap, aux)


def _capacity(t: int, moe) -> int:
    return max(int(moe.capacity_factor * moe.top_k * t / moe.n_experts + 0.5),
               1)


def _gates(w_router: torch.Tensor, x: torch.Tensor, moe):
    """``(probs, gate_vals, gate_idx)`` of tokens ``x [T, D]``: the float32
    router softmax, its top ``k`` by a stable descending sort and the
    gates normalised by ``max(sum, 1e-9)``.

    The logits are a float64 product rounded to float32: a float32 GEMM
    may give two equal router columns values that differ in the last bit
    (the columns land in different vector lanes or tails), which breaks
    the tie the reference keeps and resolves to the lower expert."""
    logits = (x.double() @ w_router.double()).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :moe.top_k], gate_idx[:, :moe.top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    return probs, gate_vals, gate_idx


def _queue(gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Each choice's place in its expert's queue, per dispatch: ``gate_idx
    [n, T, k]`` -> ``[n, T, k]``, counted in ``(token, choice)`` order."""
    n, t, k = gate_idx.shape
    # [n, E, T*k]: each expert's running count along its own contiguous row
    # (a scan down the T*k rows of [T*k, E] runs one thread per expert)
    flat = F.one_hot(gate_idx.reshape(n, t * k), e).transpose(1, 2).contiguous()
    return ((torch.cumsum(flat, dim=2) - flat) * flat).sum(1).reshape(n, t, k)


def _dispatch(p, x: torch.Tensor, moe) -> tuple[torch.Tensor, torch.Tensor]:
    t, d = x.shape
    e, k = moe.n_experts, moe.top_k
    r = moe_route(p, x, moe)
    tok = torch.arange(t, device=x.device)[:, None].expand(t, k)
    # (expert, slot) rows of the kept choices; a dropped choice points at
    # the spare row past the last slot, which the experts never see
    slot = torch.where(r.keep, r.gate_idx * r.cap + r.pos, e * r.cap)
    xin = x.new_zeros((e * r.cap + 1, d))
    xin[slot.reshape(-1)] = x[tok.reshape(-1)]
    xin = xin[:-1].view(e, r.cap, d)
    h = F.silu(torch.bmm(xin, p.wi)) * torch.bmm(xin, p.wg)
    out = torch.cat([torch.bmm(h, p.wo).reshape(e * r.cap, d),
                     x.new_zeros((1, d))])
    # combine: the gates rounded to x.dtype (the reference's comb), each
    # product exact in float32, summed over the kept choices in expert
    # order in float32 and rounded once, as a float32-accumulated dot
    gates = torch.where(r.keep, r.gate_vals, 0.0).to(x.dtype).float()
    order = torch.argsort(r.gate_idx, dim=-1)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        c = order[:, j:j + 1]
        y += (torch.gather(gates, 1, c)
              * out[torch.gather(slot, 1, c)[:, 0]].float())
    return y.to(x.dtype), r.aux


def moe_apply(p, x: torch.Tensor, moe, *, slab: int = SLAB
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [T, D]`` -> ``(y [T, D], aux)``: the reference's token-dropping
    top-k MoE.  When ``T > slab`` and ``slab`` divides ``T``, the tokens go
    in slabs of ``slab``, each routed with its own capacity, and ``aux`` is
    the mean over slabs; otherwise all tokens go in one dispatch.  ``p``
    holds ``w_router [D, E]`` (float32) and the experts' ``wi``, ``wg``
    ``[E, D, F]`` and ``wo [E, F, D]``."""
    t = x.shape[0]
    if t > slab and t % slab == 0:
        ys, auxs = zip(*(_dispatch(p, xs, moe) for xs in x.split(slab)))
        return torch.cat(ys), torch.stack(auxs).mean()
    return _dispatch(p, x, moe)


def moe_apply_mesh(ps: list, xs: list, moe, mesh, *, model_axis, first: list,
                   n_tokens: int, slab: int = SLAB, with_aux: bool = False):
    """:func:`moe_apply` over ``mesh``: ``xs[p] [T_p,
    D]`` are the tokens of position ``p``'s data group (a row of
    ``axis_groups(mesh, model_axis)``), the same at each of its positions,
    ``first[p]`` the index of ``xs[p][0]`` among all ``n_tokens`` tokens in
    ``[B, S]`` order; ``ps[p]`` holds ``w_router`` whole and ``wi``, ``wg``,
    ``wo`` of the position's block of experts (whole along ``D``).
    Returns ``ys[p] [T_p, D]`` in ``xs[p].dtype``.

    The dispatches are :func:`moe_apply`'s (slabs of ``slab`` tokens when
    that divides a longer input, else one), each with its own capacity
    ``C``; the slots of a dispatch split over the data groups where ``C >=
    1024`` (the reference's ``cap_axis``), else each group holds them all.
    A position routes its group's tokens (the choices of other groups'
    tokens in a shared dispatch come by all-gather), scatters them into
    buffers ``[E_m, dispatches, C, D]`` of its experts, whose slot blocks
    go to the positions holding them (all-to-all); there the experts run
    as batched products; the outputs come back (all-to-all) and each
    position adds, per token in expert order in float32, the gated outputs
    of its experts; an all-reduce over ``model_axis`` adds the positions'
    shares, rounded once to ``xs``' dtype.  With ``with_aux`` it returns
    ``(ys, aux)``, the balance term (:func:`_balance_mesh`) a float32
    scalar at the first position of the first data group.  Every move is
    ``sharding.send``, so the function is differentiable and its backward's
    moves are reported too."""
    rows = axis_groups(mesh, model_axis)
    n_groups, n_cols = rows.shape
    devs = mesh.devices.ravel()
    e, k = moe.n_experts, moe.top_k
    if e % n_cols:
        raise ValueError(f"{e} experts do not divide over {n_cols} positions")
    per = slab if n_tokens > slab and n_tokens % slab == 0 else n_tokens
    cap = _capacity(per, moe)
    n_disp = n_tokens // per
    split = cap >= 1024 and n_groups > 1
    slots = shard_bounds(cap, n_groups) if split else [(0, cap)] * n_groups
    where = {int(p): (g, m) for g, row in enumerate(rows)
             for m, p in enumerate(row)}
    span = []                      # each group's tokens and dispatches
    for g in range(n_groups):
        p = int(rows[g][0])
        t0, t1 = first[p], first[p] + xs[p].shape[0]
        d0 = t0 // per
        span.append((t0, t1, d0, -(-t1 // per) if t1 > t0 else d0))
    gates, probs = [None] * mesh.size, [None] * mesh.size
    for p in range(mesh.size):
        with at_position(p):
            pr, gate_vals, gate_idx = _gates(ps[p]["w_router"], xs[p], moe)
            probs[p], gates[p] = pr, (gate_vals, gate_idx)

    # route and scatter: buffers [E_m, nd, C, D] (and a spare row)
    bufs, routes = [None] * mesh.size, [None] * mesh.size
    for p in range(mesh.size):
        g, m = where[p]
        t0, t1, d0, d1 = span[g]
        nd, x = d1 - d0, xs[p]
        e0, e1 = shard_bounds(e, n_cols)[m]
        with at_position(p):
            if nd == 0:
                bufs[p] = x.new_zeros((e1 - e0, 0, cap, x.shape[1]))
                continue
            parts = []
            for h in range(n_groups):
                a, b = max(span[h][0], d0 * per), min(span[h][1], d1 * per)
                if a >= b:
                    continue
                q = int(rows[h][m])
                idx = gates[q][1][a - span[h][0]:b - span[h][0]]
                parts.append(send(idx, q, p, "all-gather", devs[p]))
            idx_all = torch.cat(parts) if len(parts) > 1 else parts[0]
            pos = _queue(idx_all.reshape(nd, per, k), e).reshape(nd * per, k)
            lo = t0 - d0 * per
            pos = pos[lo:lo + (t1 - t0)]
            gate_vals, gate_idx = gates[p]
            disp = (torch.arange(t1 - t0, device=x.device) + lo) // per
            mine = (pos < cap) & (gate_idx >= e0) & (gate_idx < e1)
            spare = (e1 - e0) * nd * cap
            slot = torch.where(
                mine, ((gate_idx - e0) * nd + disp[:, None]) * cap + pos,
                spare)
            buf = x.new_zeros((spare + 1, x.shape[1]))
            buf[slot.reshape(-1)] = x.repeat_interleave(k, dim=0)
            bufs[p] = buf[:-1].view(e1 - e0, nd, cap, x.shape[1])
            routes[p] = (slot, torch.where(mine, gate_vals, 0.0))

    # dispatch, experts, combine
    outs = [None] * mesh.size
    for p in range(mesh.size):
        g, m = where[p]
        c0, c1 = slots[g]
        src = bufs[p]
        with at_position(p):
            xin = src.new_zeros((src.shape[0], n_disp, c1 - c0, src.shape[3]))
            for h in range(n_groups):
                q = int(rows[h][m])
                if span[h][3] == span[h][2]:
                    continue
                piece = bufs[q][:, :, c0:c1]
                xin[:, span[h][2]:span[h][3]] += send(piece, q, p,
                                                      "all-to-all", devs[p])
            w = ps[p]
            flat = xin.view(xin.shape[0], -1, xin.shape[3])
            hid = F.silu(torch.bmm(flat, w["wi"])) * torch.bmm(flat, w["wg"])
            outs[p] = torch.bmm(hid, w["wo"]).view(xin.shape)
    shares = [None] * mesh.size
    for p in range(mesh.size):
        g, m = where[p]
        t0, t1, d0, d1 = span[g]
        x = xs[p]
        with at_position(p):
            if routes[p] is None:
                shares[p] = torch.zeros(x.shape, dtype=torch.float32,
                                        device=x.device)
                continue
            if split:
                # the group's dispatches' slot blocks from each group
                parts = []
                for h in range(n_groups):
                    q = int(rows[h][m])
                    piece = outs[q][:, d0:d1]
                    parts.append(send(piece, q, p, "all-to-all", devs[p]))
                out = torch.cat(parts, dim=2)
            else:
                out = outs[p][:, d0:d1]
            out = torch.cat([out.reshape(-1, x.shape[1]),
                             x.new_zeros((1, x.shape[1]))])
            slot, gate = routes[p]
            gate = gate.to(x.dtype).float()
            order = torch.argsort(gates[p][1], dim=-1)
            y = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                            device=x.device)
            for j in range(k):
                c = order[:, j:j + 1]
                y += (torch.gather(gate, 1, c)
                      * out[torch.gather(slot, 1, c)[:, 0]].float())
            shares[p] = y
    ys = psum(shares, mesh, model_axis)
    out = []
    for p, (y, x) in enumerate(zip(ys, xs)):
        with at_position(p):
            out.append(y.to(x.dtype))
    if not with_aux:
        return out
    return out, _balance_mesh(gates, probs, rows, span, per, n_disp, e, devs)


def _balance_mesh(gates, probs, rows, span, per: int, n_disp: int, e: int,
                  devs) -> torch.Tensor:
    """The Switch balance term of :func:`moe_apply_mesh`'s dispatches,
    :func:`moe_route`'s ``aux`` averaged over the dispatches as
    :func:`moe_apply` averages it over slabs: each data group's first
    position counts its tokens' first choices and sums their router
    probabilities per dispatch (``[n_disp, E]``, zero for the dispatches it
    has no token of), the groups' sums are added at the first group's
    first position (an all-reduce: a dispatch may span groups, and its
    ``f_e`` and ``P_e`` are means over all its tokens), and there ``E *
    sum_e f_e P_e`` per dispatch, averaged.  Differentiable in the
    probabilities."""
    home = int(rows[0][0])
    total = None
    for g, row in enumerate(rows):
        p = int(row[0])
        t0, t1, d0, d1 = span[g]
        if d1 == d0:
            continue
        with at_position(p):
            disp = torch.arange(t0, t1, device=devs[p]) // per
            first = F.one_hot(gates[p][1][:, 0], e).float()
            part = torch.stack([
                probs[p].new_zeros((n_disp, e)).index_add(0, disp, first),
                probs[p].new_zeros((n_disp, e)).index_add(0, disp, probs[p])])
        with at_position(home):
            part = send(part, p, home, "all-reduce", devs[home])
            total = part if total is None else total + part
    with at_position(home):
        if total is None:
            return torch.zeros((), dtype=torch.float32, device=devs[home])
        fe, pe = total / per
        return (e * torch.sum(fe * pe, dim=-1)).mean()
