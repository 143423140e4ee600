"""The port's packed multi-tenant path and `SolverService` against the JAX
package, on plans JAX programmed and carried across with
`repro_torch.interop` (programming noise cannot be replayed).

Tolerances: arena-form paths compare with JAX at rtol 2e-4 of max|x|
(explicit inverses from another LAPACK path, TESTING.md); packed against
per-instance runs inside the port at 1e-5 of max|x| (the same math,
batched matmuls may sum in another order).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro.serve import SolverService as JService
from repro_torch import interop
from repro_torch.core import blockamc as tb
from repro_torch.serve import solver_service as tservice
from repro_torch.serve import SolverService
from _torch_parity import flat_plan_dict, scaled_close, t, torch_cfg

JCFG = JCfg(array_size=4, nonideal=JNi(sigma=0.05), opa_gain=1e4)
TCFG = torch_cfg(JCFG)
N, STAGES = 16, 2          # uniform plan: 23 tiles of 4x4


def _matrices(m, n=N, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(m):
        x = rng.normal(size=(4 * n, n))
        out.append((x.T @ x / (4 * n)).astype(np.float32))
    return out


def _carried(m, n=N, seed=0):
    """JAX-programmed solvers and their carried-over port counterparts."""
    jsolvers, tsolvers = [], []
    for i, a in enumerate(_matrices(m, n, seed)):
        js = jb.ProgrammedSolver.program(jnp.asarray(a),
                                         jax.random.PRNGKey(seed + i), JCFG,
                                         STAGES)
        jsolvers.append(js)
        tsolvers.append(interop.solver_from_numpy(flat_plan_dict(js.flat),
                                                  TCFG, device="cpu"))
    return jsolvers, tsolvers


def test_program_packed_matches_per_instance_execute_arena():
    As = np.stack(_matrices(3))
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    pp = tb.program_packed(As, gens, TCFG, STAGES, device="cpu")
    assert pp.num_instances == 3 and pp.program_ops is not None
    solvers = [tb.ProgrammedSolver.program(
        a, torch.Generator().manual_seed(i), TCFG, STAGES, device="cpu")
        for i, a in enumerate(As)]
    bs = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, size=(3, N, 5)).astype(np.float32))
    for use_kernel in (False, True):      # True: the kernel's plain version
        xs = tb.execute_arena_packed(pp, bs, use_kernel=use_kernel)
        for i, s in enumerate(solvers):
            scaled_close(xs[i], tb.execute_arena(s.arena, bs[i]), 1e-5)
        scaled_close(tb.execute_arena_packed(pp, bs[..., 0],
                                             use_kernel=use_kernel),
                     xs[..., 0], 1e-6)


def test_execute_arena_packed_matches_jax_on_carried_plans():
    jsolvers, tsolvers = _carried(3)
    jpp = jb.pack_arena_plans([s.arena for s in jsolvers])
    tpp = tb.pack_arena_plans([s.arena for s in tsolvers])
    for f in ("levels", "out_spec", "arena_size", "in_off", "slot_offsets",
              "kernel_ok", "num_instances"):
        assert getattr(tpp, f) == getattr(jpp, f), f
    bs = np.random.default_rng(2).uniform(-1, 1, size=(3, N, 3)).astype(
        np.float32)
    ref = jax.jit(partial(jb.execute_arena_packed, use_kernel=False))(
        jpp, jnp.asarray(bs))
    for use_kernel in (False, True):
        scaled_close(tb.execute_arena_packed(tpp, t(bs),
                                             use_kernel=use_kernel),
                     ref, 2e-4)


def test_pack_refuses_mixed_signatures():
    _, (s16,) = _carried(1)
    _, (s8,) = _carried(1, n=8)
    with pytest.raises(ValueError, match="not stackable"):
        tb.pack_arena_plans([s16.arena, s8.arena])
    with pytest.raises(ValueError):
        tb.pack_arena_plans([])


def test_solver_service_flushes_match_jax_service():
    """Ragged per-tenant queues, a second signature bucket (n=8), a packed
    flush_all, then a single-tenant flush: the port answers as the JAX
    service does on the same carried plans, with the same counters."""
    jsolvers, tsolvers = _carried(3)
    jsmall, tsmall = _carried(1, n=8, seed=5)
    jsvc, tsvc = JService(JCFG, stages=STAGES), SolverService(
        TCFG, stages=STAGES, device="cpu")
    mats = _matrices(3) + _matrices(1, n=8, seed=5)
    ids = ["a", "b", "c", "small"]
    for mid, js, ts, a in zip(ids, jsolvers + jsmall, tsolvers + tsmall,
                              mats):
        jsvc.install(mid, js, jnp.asarray(a))
        tsvc.install(mid, ts, a)
    rng = np.random.default_rng(3)
    queues = {"a": 3, "b": 1, "c": 5, "small": 2}
    for mid, k in queues.items():
        n = 8 if mid == "small" else N
        for _ in range(k):
            b = rng.uniform(-1, 1, size=n).astype(np.float32)
            assert jsvc.submit(mid, jnp.asarray(b)) == \
                tsvc.submit(mid, torch.from_numpy(b))
    assert {m: tsvc.pending(m) for m in ids} == queues
    got, want = tsvc.flush_all(), jsvc.flush_all()
    assert sorted(got) == sorted(want) == sorted(ids)
    for mid in ids:
        assert got[mid].shape == want[mid].shape == (
            8 if mid == "small" else N, queues[mid])
        scaled_close(got[mid], want[mid], 2e-4)
        assert tsvc.pending(mid) == 0
    b = rng.uniform(-1, 1, size=(2, N)).astype(np.float32)
    for col in b:
        tsvc.submit("b", torch.from_numpy(col))
        jsvc.submit("b", jnp.asarray(col))
    scaled_close(tsvc.flush("b"), jsvc.flush("b"), 2e-4)
    scaled_close(tsvc.solve("a", t(b.T)), jsvc.solve("a", jnp.asarray(b.T)),
                 2e-4)
    for mid in ids:
        ts_, js_ = tsvc.stats(mid), jsvc.stats(mid)
        assert (ts_.solve_calls, ts_.rhs_served) == \
            (js_.solve_calls, js_.rhs_served)
    assert tsvc.flush("a").shape == (N, 0)
    assert tsvc.flush_all() == {}


def test_solver_service_front_door_and_two_phase_commit(monkeypatch):
    svc = SolverService(TCFG, stages=STAGES, device="cpu")
    a, a2 = _matrices(2)
    for bad in (np.full((N, N), np.nan, np.float32), a[:, :5],
                a.astype(np.int32)):
        with pytest.raises(ValueError):
            svc.program("x", bad)
    assert svc.matrix_ids == ()
    svc.program("x", a, torch.Generator().manual_seed(1))
    svc.program("y", a2)
    with pytest.raises(ValueError, match="non-finite"):
        svc.submit("x", torch.full((N,), float("inf")))
    with pytest.raises(ValueError):
        svc.submit("x", torch.zeros(N + 1))
    with pytest.raises(ValueError, match="floating"):
        svc.submit("x", torch.zeros(N, dtype=torch.int64))
    assert svc.pending("x") == 0
    buf = torch.ones(N)
    svc.submit("x", buf)
    buf += 1.0                            # a queued request is a copy
    svc.submit("y", buf)
    with pytest.raises(RuntimeError, match="pending"):
        svc.program("x", a)
    for name in ("solve_refined", "solve_fallback"):
        with pytest.raises(NotImplementedError):
            getattr(svc, name)("x", buf)
    with pytest.raises(NotImplementedError):
        svc.flush("x", refined=True)

    def boom(*args, **kw):
        raise RuntimeError("device lost")
    monkeypatch.setattr(tservice, "execute_arena_packed", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        svc.flush_all()
    assert (svc.pending("x"), svc.pending("y")) == (1, 1)
    assert svc.stats("x").solve_calls == 0
    monkeypatch.undo()
    out = svc.flush_all()
    x_direct = svc.solver("x").solve(torch.ones(N))
    scaled_close(out["x"][:, 0], x_direct, 1e-5)
    assert svc.discard_pending("x") == 0
    svc.submit("x", buf)
    assert svc.discard_pending("x") == 1 and svc.pending("x") == 0


def test_service_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the request would succeed")
    with pytest.raises(RuntimeError, match="cuda"):
        SolverService(TCFG)
