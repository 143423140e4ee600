"""Batched nodal (MNA) crossbar solver: the exact wire model, as in
`repro/physics/nodal.py`.

The wired crossbar is a 2*nr*nc-node resistive network: bit-line nodes
b(i,j) joined vertically by wire segments (conductance gw = 1/r_seg),
word-line nodes w(i,j) joined horizontally, and the cell g[i,j] bridging
b(i,j) and w(i,j).  The input drive enters at row 0 of each bit line
through one segment; the sense node sits one segment past the last column
of each word line, at virtual ground.  This module solves that network
exactly, in the reference's formulation:

1. Residual unknowns: b(i,j) = v_in[j] + beta(i,j), w(i,j) = omega(i,j).
   The right-hand side is then O(g) and the solution is the IR-drop effect
   itself, so float32 stays usable (no cancellation against gw ~ 1e4 g).

2. Word-line elimination.  Within row i the word-line nodes form
   W_i = tridiag(-gw, wd_i, -gw), wd_i[j] = g[i,j] + gw*((j>0) + (j<nc-1)
   + (j==nc-1)).  Eliminating them leaves a block-tridiagonal system in
   beta alone, with off-diagonal blocks -gw*I:

       -gw beta_{i-1} + S_i beta_i - gw beta_{i+1} = rhs_i,
       S_i = diag(db_i) - diag(g_i) W_i^{-1} diag(g_i),
       db_i[j] = g[i,j] + gw*((i>0) + (i<nr-1) + (i==0)),
       rhs_i = g_i * (W_i^{-1}(g_i * v_in) - v_in).

3. Block-Thomas factor and sweeps: M_0 = S_0, M_i = S_i - gw^2 M_{i-1}^{-1},
   Minv_i = M_i^{-1}; then z_i = Minv_i (rhs_i + gw z_{i-1}) forward and
   x_i = z_i + gw Minv_i x_{i+1} backward.  The sweeps are the hand-written
   CUDA kernel on the card (`kernels/banded_solve.py`); the factorisation
   stays in plain PyTorch (`torch.linalg.inv_ex`), as the reference leaves it
   to XLA.

4. Outputs: sense currents I_i = gw * omega_i[nc-1]; the exact effective
   conductance H = sense^T L^{-1} drive is the MVM solve of an identity
   drive; the INV circuit reduces to u = -g0 H^{-1} v_in.

Differences from the reference, by design: the reference's `lax.scan`s
become Python loops.  The per-row Thomas solves that build S_i do not
depend on the block-Thomas carry, so they run as one batched Thomas over
all rows before the recursion (the same arithmetic, element for element);
the Thomas elimination coefficients of W_i, which depend only on wd_i, are
computed once and shared by the three solves against W_i; and the sense
current needs only the last word-line node, which the forward elimination
of a Thomas solve gives without its backward pass.  So a readout takes
about 7*nc + 5*nr host-issued steps around one kernel launch.

Every function takes torch tensors; stacks carry leading batch axes.
`use_kernel=None` runs the sweeps in the CUDA kernel for a tensor on the
card and in the plain version (`kernels/ref.py`) for one on the host;
False asks for the plain version; True on a host tensor raises.  r_seg == 0
is the ideal-wire limit and short-circuits before any solve.
"""
from __future__ import annotations

from typing import Optional

import torch

# Chunk budget of the readout path (`nonideal.wire_readout`): a chunk's
# Minv stack (chunk, nr, nc, nc) stays under this many bytes - 8 crossbars
# of 256 x 256 in float32 - and the whole readout, with its Thomas
# intermediates of the same size, at a few GB.
READOUT_CHUNK_BYTES = 1 << 29


def readout_chunk(nr: int, nc: int, dtype: torch.dtype) -> int:
    """Crossbars per chunk of a readout under `READOUT_CHUNK_BYTES`."""
    per = nr * nc * nc * torch.empty((), dtype=dtype).element_size()
    return max(1, READOUT_CHUNK_BYTES // per)


# ---------------------------------------------------------------------------
# Structured assembly
# ---------------------------------------------------------------------------

def _wl_diag(g: torch.Tensor, gw: float) -> torch.Tensor:
    """Diagonals wd_i of the word-line tridiagonals W_i; (..., nr, nc)."""
    nc = g.shape[-1]
    j = torch.arange(nc, device=g.device)
    seg = (j > 0).to(g.dtype) + (j < nc - 1).to(g.dtype) \
        + (j == nc - 1).to(g.dtype)               # sense segment
    return g + gw * seg


def _bl_diag(g: torch.Tensor, gw: float) -> torch.Tensor:
    """Diagonal entries db_i of the bit-line blocks; (..., nr, nc)."""
    nr = g.shape[-2]
    i = torch.arange(nr, device=g.device)
    seg = (i > 0).to(g.dtype) + (i < nr - 1).to(g.dtype) \
        + (i == 0).to(g.dtype)                    # driver segment
    return g + gw * seg[:, None]


def _thomas_factor(d: torch.Tensor, gw: float):
    """Forward-elimination coefficients of tridiag(-gw, d, -gw) over the
    last axis of d (..., m): per step j, (cp_j, denom_j[..., None]).  They
    depend on d alone, so every solve against one matrix shares them."""
    cp = torch.zeros_like(d[..., 0])
    steps = []
    for j in range(d.shape[-1]):
        denom = d[..., j] + gw * cp              # b_j - a cp_{j-1}, a = -gw
        cp = -gw / denom
        steps.append((cp[..., None], denom[..., None]))
    return steps


def _thomas_forward(fac, gw: float, rhs: torch.Tensor):
    """The forward elimination of rhs (..., m, k): the list of dp_j."""
    dp = torch.zeros_like(rhs[..., 0, :])
    dps = []
    for j, (_, denom) in enumerate(fac):
        dp = (rhs[..., j, :] + gw * dp) / denom
        dps.append(dp)
    return dps


def _thomas_apply(fac, gw: float, rhs: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(-gw, d, -gw) x = rhs given `_thomas_factor(d, gw)`;
    rhs (..., m, k), solved along axis -2."""
    dps = _thomas_forward(fac, gw, rhs)
    x = dps[-1]                                  # x_{m-1} = dp_{m-1}
    xs = [x]
    for j in range(len(fac) - 2, -1, -1):
        x = dps[j] - fac[j][0] * x
        xs.append(x)
    return torch.stack(xs[::-1], dim=-2)


def _thomas_solve(d: torch.Tensor, gw: float,
                  rhs: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(-gw, d, -gw) x = rhs along axis -2 of rhs (..., m, k);
    d (..., m) holds the diagonals, everything else is batch."""
    return _thomas_apply(_thomas_factor(d, gw), gw, rhs)


def _schur_blocks(g: torch.Tensor, wfac, gw: float) -> torch.Tensor:
    """S_i = diag(db_i) - g_i[:, None] * W_i^{-1} diag(g_i) for every row
    at once; (..., nr, nc, nc)."""
    x = _thomas_apply(wfac, gw, torch.diag_embed(g))
    return torch.diag_embed(_bl_diag(g, gw)) - g[..., :, None] * x


def row_schur_blocks(g, r_seg: float) -> torch.Tensor:
    """The nr dense (nc x nc) diagonal blocks S_i after word-line
    elimination; (..., nr, nc, nc).  Each S_i is symmetric positive
    definite."""
    g = torch.as_tensor(g)
    gw = 1.0 / float(r_seg)
    return _schur_blocks(g, _thomas_factor(_wl_diag(g, gw), gw), gw)


# ---------------------------------------------------------------------------
# Block-Thomas factor + sweeps
# ---------------------------------------------------------------------------

def _factor(g: torch.Tensor, gw: float, wfac=None) -> torch.Tensor:
    """The explicit-inverse factor stack Minv (..., nr, nc, nc).

    The S_i stack is built first, then overwritten row by row with
    Minv_i = (S_i - gw^2 Minv_{i-1})^{-1}, so the recursion holds one
    stack of that size.  Every M_i is symmetric positive definite, so the
    inverse skips the singularity check (`inv_ex`), whose result would be
    read on the host at every row and stall the card.  `wfac` is
    `_thomas_factor` of the word-line diagonals, when the caller has it.
    """
    if wfac is None:
        wfac = _thomas_factor(_wl_diag(g, gw), gw)
    ms = _schur_blocks(g, wfac, gw)
    for i in range(ms.shape[-3]):
        m_i = ms[..., i, :, :]
        if i:
            m_i = m_i - (gw * gw) * ms[..., i - 1, :, :]
        ms[..., i, :, :] = torch.linalg.inv_ex(m_i).inverse
    return ms


def _sweeps(minvs: torch.Tensor, rhs: torch.Tensor, gw: float,
            use_kernel: Optional[bool]) -> torch.Tensor:
    """Batched sweep dispatch: (B, nr, nc, nc) x (B, nr, nc, k)."""
    from repro_torch.kernels import ops as _ops
    from repro_torch.kernels import ref as _ref
    if use_kernel is None:
        use_kernel = rhs.is_cuda
    if not use_kernel:
        return _ref.block_tridiag_solve_ref(minvs, rhs, gw=gw)
    if not rhs.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors: the "
                         "block-Thomas kernel has no host mode")
    return _ops.block_tridiag_solve(minvs, rhs, gw=gw)


# ---------------------------------------------------------------------------
# MVM pipeline over a (B, nr, nc) stack
# ---------------------------------------------------------------------------

def _mvm_prepare(g: torch.Tensor, v: torch.Tensor, gw: float):
    """Stage A: the residual rhs, the Minv factor stack and the word-line
    Thomas coefficients (shared with stage C)."""
    wfac = _thomas_factor(_wl_diag(g, gw), gw)
    vb = v[..., None, :, :]                           # (B, 1, nc, k)
    gv = g[..., None] * vb                            # (B, nr, nc, k)
    y = _thomas_apply(wfac, gw, gv)                   # W_i^{-1}(g_i * v)
    rhs = g[..., None] * (y - vb)
    return _factor(g, gw, wfac), rhs, wfac


def _mvm_recover(g: torch.Tensor, v: torch.Tensor, wfac, beta: torch.Tensor,
                 gw: float) -> torch.Tensor:
    """Stage C: sense currents gw * omega_i[nc-1] from beta; (B, nr, k).
    The last word-line node is the last step of the forward elimination."""
    drive = g[..., None] * (v[..., None, :, :] + beta)
    return gw * _thomas_forward(wfac, gw, drive)[-1]


def _mvm_batched(g: torch.Tensor, v: torch.Tensor, gw: float,
                 use_kernel: Optional[bool]) -> torch.Tensor:
    """(B, nr, nc) x (B, nc, k) -> (B, nr, k) sense currents."""
    minvs, rhs, wfac = _mvm_prepare(g, v, gw)
    beta = _sweeps(minvs, rhs, gw, use_kernel)
    del minvs, rhs
    return _mvm_recover(g, v, wfac, beta, gw)


# ---------------------------------------------------------------------------
# Public API: one crossbar
# ---------------------------------------------------------------------------

def nodal_mvm_currents(g, v_in, r_seg: float, *,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Exact sense currents of the MVM crossbar g (nr, nc) for v_in (nc,)
    or (nc, k).  r_seg == 0 short-circuits to g @ v_in."""
    g = torch.as_tensor(g)
    v = torch.as_tensor(v_in, device=g.device)
    if r_seg == 0.0:
        return g @ v
    vec = v.ndim == 1
    v2 = v[:, None] if vec else v
    out = _mvm_batched(g[None], v2[None].to(g.dtype), 1.0 / float(r_seg),
                       use_kernel)[0]
    return out[:, 0] if vec else out


def nodal_effective_conductance(g, r_seg: float, *,
                                use_kernel: Optional[bool] = None
                                ) -> torch.Tensor:
    """Exact effective conductance H = sense^T L^{-1} drive of the wired
    crossbar (the MVM solve of an identity drive): H @ v equals the exact
    sense currents for any drive v."""
    g = torch.as_tensor(g)
    if r_seg == 0.0:
        return g
    eye = torch.eye(g.shape[1], dtype=g.dtype, device=g.device)
    return nodal_mvm_currents(g, eye, r_seg, use_kernel=use_kernel)


def nodal_inv_outputs(g, v_in, r_seg: float, g0: float, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Exact OPA outputs of the INV feedback circuit with wire resistance:
    u = -g0 H^{-1} v_in with H the exact effective conductance."""
    g = torch.as_tensor(g)
    nr, nc = g.shape
    assert nr == nc, "INV circuit requires a square array"
    v = torch.as_tensor(v_in, device=g.device)
    if r_seg == 0.0:
        return -g0 * torch.linalg.solve(g, v.to(g.dtype))
    h = nodal_effective_conductance(g, r_seg, use_kernel=use_kernel)
    return -g0 * torch.linalg.solve(h, v.to(h.dtype))


# ---------------------------------------------------------------------------
# Monte-Carlo batches: a whole stack of crossbars
# ---------------------------------------------------------------------------

def _broadcast_drive(g: torch.Tensor, v_in):
    """Normalise v_in to (B, nc, k) against a (B, nr, nc) stack; returns
    (drive, was_vector)."""
    b, nr, nc = g.shape
    v = torch.as_tensor(v_in, dtype=g.dtype, device=g.device)
    vec = False
    if v.ndim == 1:                       # (nc,) shared vector
        vec = True
        v = v[None, :, None].expand(b, nc, 1)
    elif v.ndim == 2:
        if tuple(v.shape) == (b, nc) and b != nc:   # per-instance vector
            vec = True
            v = v[:, :, None]
        else:                             # (nc, k) shared multi-drive
            # NB: when B == nc a (B, nc) array is read as a shared
            # multi-drive; pass (B, nc, 1) to force per-instance vectors.
            v = v[None].expand((b,) + tuple(v.shape))
    return v, vec


def nodal_mvm_batched(g, v_in, r_seg: float, *, chunk: Optional[int] = None,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Sense currents for a (B, nr, nc) crossbar stack.

    v_in: (nc,), (B, nc), (nc, k) or (B, nc, k).  `chunk` bounds peak
    memory: the stack runs through the pipeline `chunk` crossbars at a time
    (the Minv stack is (chunk, nr, nc, nc)); None runs it whole.
    """
    g = torch.as_tensor(g)
    v, vec = _broadcast_drive(g, v_in)
    if r_seg == 0.0:
        out = torch.einsum("brc,bck->brk", g, v)
        return out[..., 0] if vec else out
    gw = 1.0 / float(r_seg)
    b = g.shape[0]
    step = b if chunk is None or chunk >= b else max(int(chunk), 1)
    outs = [_mvm_batched(g[i:i + step], v[i:i + step], gw, use_kernel)
            for i in range(0, b, step)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[..., 0] if vec else out


def nodal_effective_conductance_batched(g, r_seg: float, *,
                                        chunk: Optional[int] = None,
                                        use_kernel: Optional[bool] = None
                                        ) -> torch.Tensor:
    """Exact H for a (B, nr, nc) stack of crossbars; (B, nr, nc) out."""
    g = torch.as_tensor(g)
    if r_seg == 0.0:
        return g
    eye = torch.eye(g.shape[2], dtype=g.dtype, device=g.device)
    return nodal_mvm_batched(g, eye, r_seg, chunk=chunk,
                             use_kernel=use_kernel)


def nodal_inv_batched(g, v_in, r_seg: float, g0: float, *,
                      chunk: Optional[int] = None,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """INV outputs for a (B, n, n) stack: u = -g0 H^{-1} v per instance."""
    g = torch.as_tensor(g)
    h = nodal_effective_conductance_batched(g, r_seg, chunk=chunk,
                                            use_kernel=use_kernel)
    v, vec = _broadcast_drive(g, v_in)
    out = -g0 * torch.linalg.solve(h, v)
    return out[..., 0] if vec else out
