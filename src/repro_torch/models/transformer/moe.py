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
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..common import Split, dense_init

__all__ = ["MoERoute", "init_moe", "moe_route", "moe_apply",
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
    e, k = moe.n_experts, moe.top_k
    cap = max(int(moe.capacity_factor * k * t / e + 0.5), 1)
    logits = x.float() @ p.w_router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    # Switch balance term on the first choice: E * sum_e f_e * P_e
    fe = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(fe * probs.mean(dim=0))
    # [E, T*k]: each expert's running count along its own contiguous row
    # (a scan down the T*k rows of [T*k, E] runs one thread per expert)
    flat = F.one_hot(gate_idx.reshape(-1), e).t().contiguous()
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(0).reshape(t, k)
    return MoERoute(gate_idx, gate_vals, pos, pos < cap, cap, aux)


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
