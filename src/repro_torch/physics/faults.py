"""Stuck-at device faults with fault-aware row/column remapping, as in
`repro/physics/faults.py`.

A fraction of devices is stuck at G_on or G_off whatever is programmed.
A physical fault at (i, j) under row/column permutations p, q lands on
logical entry (p[i], q[j]), so the masks are permuted into logical space
and stamped onto the unpermuted target: executors and plans never see
the permutation.

Remap objective: the per-fault squared target mismatch
sum over faults (g_target[logical] - g_stuck)^2, minimised greedily -
physical rows in decreasing fault burden take the cheapest remaining
logical row, then the same for columns.

Every function takes (..., r, c) stacks and treats each trailing 2-D
slice as one array.  The masks are drawn from the caller's
`torch.Generator` as one uniform draw for the whole stack
(`sample_stuck_masks`); `apply_stuck_masks` takes masks made elsewhere.
The reference's sort is stable and its argmin takes the first minimum;
so do these (`stable=True`, `torch.argmin`), so the same masks give the
same remap.
"""
from __future__ import annotations

import torch


def stuck_masks(u: torch.Tensor, p_on: float, p_off: float):
    """Disjoint stuck-ON / stuck-OFF masks from uniforms u in [0, 1)."""
    return u < p_on, u >= 1.0 - p_off


def sample_stuck_masks(generator: torch.Generator, shape, p_on: float,
                       p_off: float, device=None):
    """Disjoint boolean masks of stuck-ON / stuck-OFF devices
    (p_on + p_off <= 1), from one uniform draw of `shape` on the
    generator's device, moved to `device` (default: the generator's)."""
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device)
    if device is not None:
        u = u.to(device)
    return stuck_masks(u, p_on, p_off)


def _greedy_assign(cost: torch.Tensor, burden: torch.Tensor) -> torch.Tensor:
    """Greedy min-cost matching over a batch: cost (B, P, L), burden (B, P).
    Physical slot i (in decreasing burden, ties in index order) takes the
    cheapest still-available logical slot (ties: the lowest index).
    Returns p (B, P) with p[b, i] = logical slot hosted by physical i."""
    order = torch.argsort(-burden, dim=-1, stable=True)
    rows = torch.arange(cost.shape[0], device=cost.device)
    avail = torch.ones(cost.shape[0], cost.shape[2], dtype=torch.bool,
                       device=cost.device)
    inf = torch.tensor(float("inf"), dtype=cost.dtype, device=cost.device)
    ordered = torch.take_along_dim(cost, order[..., None], dim=1)
    assigned = []
    for step in range(cost.shape[1]):
        a = torch.argmin(torch.where(avail, ordered[:, step], inf), dim=-1)
        avail[rows, a] = False
        assigned.append(a)
    p = torch.empty_like(order)
    p.scatter_(1, order, torch.stack(assigned, dim=1))
    return p


def fault_aware_permutations(g_target: torch.Tensor, on: torch.Tensor,
                             off: torch.Tensor, g_on: float, g_off: float):
    """Fault-aware row then column assignment for a (..., r, c) stack;
    returns (p, q) with physical row i hosting logical row p[..., i]
    (likewise q for columns).  Hosting logical entry (a, b) on a faulty
    device costs (g_target[a, b] - g_stuck)^2."""
    lead, (r, c) = g_target.shape[:-2], g_target.shape[-2:]
    tgt = g_target.reshape((-1, r, c))
    fon = on.reshape((-1, r, c)).to(tgt.dtype)
    foff = off.reshape((-1, r, c)).to(tgt.dtype)
    con = (tgt - g_on) ** 2                # cost tables per logical entry
    coff = (tgt - g_off) ** 2
    # rows: cost[i, a] = sum_j on[i,j] con[a,j] + off[i,j] coff[a,j]
    cost_r = fon @ con.transpose(-1, -2) + foff @ coff.transpose(-1, -2)
    p = _greedy_assign(cost_r, torch.sum(fon + foff, dim=-1))
    inv_p = torch.argsort(p, dim=-1)
    idx = inv_p[..., None].expand(-1, -1, c)
    on_r = torch.take_along_dim(fon, idx, dim=1)   # row-remapped masks
    off_r = torch.take_along_dim(foff, idx, dim=1)
    # columns on top of the row assignment:
    # cost[j, b] = sum_a on_r[a,j] con[a,b] + off_r[a,j] coff[a,b]
    cost_c = on_r.transpose(-1, -2) @ con + off_r.transpose(-1, -2) @ coff
    q = _greedy_assign(cost_c, torch.sum(on_r + off_r, dim=-2))
    return p.reshape(lead + (r,)), q.reshape(lead + (c,))


def apply_stuck_masks(g: torch.Tensor, g_target: torch.Tensor,
                      on: torch.Tensor, off: torch.Tensor, *, g_on: float,
                      g_off: float, remap: bool = False) -> torch.Tensor:
    """Stamp given stuck masks (physical coordinates, g's shape) onto a
    programmed (..., r, c) stack; with `remap`, first route them to the
    logical entries the fault-aware assignment chooses."""
    if remap:
        p, q = fault_aware_permutations(g_target, on, off, g_on, g_off)
        # logical entry (a, b) is faulty iff physical (p^-1 a, q^-1 b) is
        inv_p = torch.argsort(p, dim=-1)
        inv_q = torch.argsort(q, dim=-1)
        c = g.shape[-1]

        def logical(mask):
            rows = torch.take_along_dim(
                mask, inv_p[..., None].expand(inv_p.shape + (c,)), dim=-2)
            return torch.take_along_dim(
                rows, inv_q[..., None, :].expand(rows.shape), dim=-1)

        on, off = logical(on), logical(off)
    stuck_on = torch.full_like(g, g_on)
    return torch.where(on, stuck_on,
                       torch.where(off, torch.full_like(g, g_off), g))


def apply_stuck_faults(g: torch.Tensor, g_target: torch.Tensor,
                       generator: torch.Generator, *, p_on: float,
                       p_off: float, g_on: float, g_off: float,
                       remap: bool = False) -> torch.Tensor:
    """Stamp stuck-at faults onto a programmed (..., r, c) stack.

    `g` is the post-write-noise state, `g_target` the noiseless targets the
    remapper matches against.  Faults are independent per device: one
    uniform per device of the stack, drawn from `generator`.
    """
    on, off = sample_stuck_masks(generator, g.shape, p_on, p_off,
                                 device=g.device)
    return apply_stuck_masks(g, g_target, on, off, g_on=g_on, g_off=g_off,
                             remap=remap)
