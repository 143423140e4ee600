"""The port's checkpoint layer and `ProgramStore` against the JAX package
(TESTING.md "Replicated serving", contract 6, and the store's three
validation layers).

* Flatten keys are `jax.tree_util.keystr`'s strings, in its order, for
  nested dict/list/tuple trees and for a programmed solver's
  {"fin", "arena"} tree; the list-index / dict-key aliasing case is
  pinned on both sides.
* The on-disk format is the reference's: the same manifest (keys, files,
  shapes, dtypes, extra) and the same leaf files.
* Stores cross packages: a store written by the JAX `ProgramStore`
  restores in the port and answers like the JAX solver (rtol 2e-4 of
  max|x|, the arena-form tolerance of TESTING.md "Executor contract"; the
  restored operators are JAX's own), and a store written by the port
  restores through the JAX store with equal arrays, LU pivots shifted to
  the reference's 0-based convention.
* Stale, truncated and value-corrupted stores raise the reference's
  errors, or (values) restore and answer wrongly, which only the engine's
  canary catches.
"""
import collections
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ProgramStore as JStore
from repro.checkpoint import ckpt as jckpt
from repro.core import blockamc as jb
from repro.core.analog import AnalogConfig as JCfg
from repro.core.nonideal import NonidealConfig as JNi
from repro_torch import interop, keys
from repro_torch.checkpoint import (CheckpointCorruptionError,
                                    CheckpointError, CheckpointManager,
                                    ProgramStore, StaleCheckpointError,
                                    latest_step, load_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import blockamc as tb
from _torch_parity import scaled_close, solver_dict, torch_cfg

JCFG = JCfg(array_size=8, nonideal=JNi(sigma=0.02))
TCFG = torch_cfg(JCFG)
NT = collections.namedtuple("NT", "a b")


def _wishart(seed, n):
    x = np.random.default_rng(seed).normal(size=(4 * n, n))
    return (x.T @ x / (4 * n) + 0.5 * np.eye(n)).astype(np.float32)


def _jax_solver(n, stages, seed=0):
    a = _wishart(seed, n)
    key = jax.random.fold_in(jax.random.PRNGKey(11), seed)
    return a, key, jb.ProgrammedSolver.program(jnp.asarray(a), key, JCFG,
                                               stages)


def _carried(js):
    return interop.solver_from_numpy(solver_dict(js), TCFG, device="cpu")


def _rhs(n, seed=3):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)


# ------------------------------------------------------------- flatten ----

TREES = [
    {"x": [np.arange(3.0), (np.ones(2), None)], "0": np.zeros(1),
     "b": {"z": 1.0, "a": NT(np.ones(1), [np.ones(2)])}},
    [np.ones(1), {"1": np.ones(2), "0": (np.zeros(3),)}],
    ({"k": [[np.ones(1)], []]}, np.zeros(2)),
]


@pytest.mark.parametrize("tree", TREES, ids=["dict", "list", "tuple"])
def test_flatten_keys_equal_keystr(tree):
    expect = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [k for k, _ in tckpt.flatten(tree)] == expect


@pytest.mark.parametrize("n,stages", [(16, 1), (32, 2)])
def test_programmed_solver_keys_shapes_dtypes_equal_the_reference(n, stages):
    _, _, js = _jax_solver(n, stages)
    ts = _carried(js)
    jtree = {"fin": js.finalized, "arena": js.arena}
    expect = [(jax.tree_util.keystr(p), np.asarray(x).shape,
               str(np.asarray(x).dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    got = [(k, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in tckpt.flatten({"fin": ts.finalized,
                                      "arena": ts.arena})]
    assert got == expect
    assert any("[<flat index 0>][0][1]" in k for k, _, _ in got)   # pivots


def test_list_index_and_dict_key_do_not_alias(tmp_path):
    """{"x": [a, b]} must not restore into {"x": {"0": .., "1": ..}}, in
    the port or, from the port's files, in the reference."""
    save_checkpoint(str(tmp_path), 0, {"x": [np.arange(4.0),
                                             np.full(4, 7.0)]})
    like = {"x": {"0": np.zeros(4), "1": np.zeros(4)}}
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 0, like)
    with pytest.raises(KeyError):
        jckpt.restore_checkpoint(str(tmp_path), 0, like)


def test_tree_roundtrip_exact_with_structure(tmp_path):
    tree = {"x": [torch.arange(4.0), np.full(4, 7.0)], "y": np.eye(3),
            "t": NT(torch.ones(2, dtype=torch.int32), None)}
    save_checkpoint(str(tmp_path), 0, tree)
    like = {"x": [torch.zeros(4), np.zeros(4)], "y": np.zeros((3, 3)),
            "t": NT(torch.zeros(2, dtype=torch.int32), None)}
    out = restore_checkpoint(str(tmp_path), 0, like)
    assert isinstance(out["t"], NT) and out["t"].b is None
    assert torch.equal(out["x"][0], torch.arange(4.0))
    assert torch.equal(out["x"][1], torch.full((4,), 7.0,
                                               dtype=torch.float64))
    assert torch.equal(out["t"].a, torch.ones(2, dtype=torch.int32))
    assert np.array_equal(out["y"].numpy(), np.eye(3))


def test_on_disk_format_equals_the_reference(tmp_path):
    tree = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "s": [np.int32(4) * np.ones(3, np.int32), {"b": np.zeros(1)}]}
    extra = {"trip": 0.5, "signature": "sig"}
    save_checkpoint(str(tmp_path / "port"), 7, tree, extra=extra)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 7, tree, extra=extra)
    mp = load_manifest(str(tmp_path / "port"), 7)
    assert mp == jckpt.load_manifest(str(tmp_path / "jax"), 7)
    for meta in mp["leaves"].values():
        a, b = (np.load(tmp_path / side / "step_00000007" / meta["file"])
                for side in ("port", "jax"))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    out = jckpt.restore_checkpoint(str(tmp_path / "port"), 7, tree)
    assert np.array_equal(np.asarray(out["w"]), tree["w"])


def test_integrity_layer_catches_truncation_and_dtype_flips(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": np.arange(64.0),
                                       "v": np.arange(8.0)})
    files = load_manifest(str(tmp_path), 0)["leaves"]
    path = tmp_path / "step_00000000"
    w = path / files["['w']"]["file"]
    with open(w, "r+b") as f:
        f.truncate(os.path.getsize(w) // 2)
    with pytest.raises(CheckpointCorruptionError):
        restore_checkpoint(str(tmp_path), 0, {"w": np.zeros(64)})
    np.save(path / files["['v']"]["file"], np.arange(8, dtype=np.int32))
    with pytest.raises(CheckpointCorruptionError):
        restore_checkpoint(str(tmp_path), 0, {"v": np.zeros(8)})
    with pytest.raises(ValueError, match="shape mismatch"):
        save_checkpoint(str(tmp_path), 1, {"v": np.zeros(8)})
        restore_checkpoint(str(tmp_path), 1, {"v": np.zeros(9)})


def test_extra_metadata_and_latest_step(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    save_checkpoint(str(tmp_path), 3, {"w": np.zeros(2)},
                    extra={"trip": 0.5, "signature": "sig"})
    save_checkpoint(str(tmp_path), 1, {"w": np.zeros(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")       # a save cut short
    assert latest_step(str(tmp_path)) == 3
    assert load_manifest(str(tmp_path), 3)["extra"] == {
        "trip": 0.5, "signature": "sig"}


def test_checkpoint_manager_snapshots_keeps_last_and_matches_layout(
        tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    w = torch.zeros(4)
    for step in range(7):
        w += 1
        saved = mgr.maybe_save(step, {"w": w, "step": [np.int64(step)]})
        assert saved == (step % 2 == 0)
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [4, 6]
    out = restore_checkpoint(str(tmp_path), 4, {"w": torch.zeros(4),
                                                "step": [np.int64(0)]})
    assert torch.equal(out["w"], torch.full((4,), 5.0))   # the snapshot
    assert int(out["step"][0]) == 4
    jout = jckpt.restore_checkpoint(str(tmp_path), 6,
                                    {"w": np.zeros(4), "step": [0]})
    assert np.array_equal(np.asarray(jout["w"]), np.full(4, 7.0))


# -------------------------------------------------------- program store --

@pytest.mark.parametrize("n,stages", [(16, 1), (32, 2)])
def test_jax_written_store_restores_in_the_port(tmp_path, n, stages):
    a, key, js = _jax_solver(n, stages)
    sig = jb.plan_signature(n, stages, JCFG)
    assert repr(sig) == repr(tb.plan_signature(n, stages, TCFG))
    JStore(str(tmp_path)).save("m", js, a, key, sig, extra={"trip": 0.25})

    template = tb.ProgrammedSolver.program(
        a, torch.Generator().manual_seed(9), TCFG, stages, device="cpu")
    ts, meta = ProgramStore(str(tmp_path)).restore(
        "m", template, a, np.asarray(key), tb.plan_signature(n, stages,
                                                             TCFG))
    assert meta["trip"] == 0.25 and not ts.repairable
    for (tlu, tpiv), (jlu, jpiv) in zip(ts.finalized.lu_stacks,
                                        js.finalized.lu_stacks):
        np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv) + 1)
        np.testing.assert_array_equal(tlu.numpy(), np.asarray(jlu))
    b = _rhs(n)
    for mode in ("fused", "reference"):
        x_jax = np.asarray(js.solve(jnp.asarray(b), mode=mode))
        scaled_close(ts.solve(torch.from_numpy(b), mode=mode), x_jax, 2e-4)


@pytest.mark.parametrize("n,stages", [(16, 1), (32, 2)])
def test_port_written_store_restores_in_the_reference(tmp_path, n, stages):
    a, jkey, js = _jax_solver(n, stages, seed=4)
    key = keys.as_key(jkey)
    ts = tb.ProgrammedSolver.program(a, keys.generator(key), TCFG, stages,
                                     device="cpu")
    ProgramStore(str(tmp_path)).save(
        "m", ts, torch.from_numpy(a), key, tb.plan_signature(n, stages,
                                                             TCFG),
        extra={"trip": 0.5})
    rs, meta = JStore(str(tmp_path)).restore(
        "m", js, a, jkey, jb.plan_signature(n, stages, JCFG))
    assert meta["trip"] == 0.5
    for (tlu, tpiv), (rlu, rpiv) in zip(ts.finalized.lu_stacks,
                                        rs.finalized.lu_stacks):
        np.testing.assert_array_equal(np.asarray(rpiv), tpiv.numpy() - 1)
        np.testing.assert_array_equal(np.asarray(rlu), tlu.numpy())
    for tst, rst in zip(ts.arena.stacks, rs.arena.stacks):
        np.testing.assert_array_equal(np.asarray(rst), tst.numpy())
    b = _rhs(n)
    for mode in ("fused", "reference"):
        scaled_close(np.asarray(rs.solve(jnp.asarray(b), mode=mode)),
                     ts.solve(torch.from_numpy(b), mode=mode).numpy(), 2e-4)


@pytest.fixture(scope="module")
def programmed():
    a = _wishart(21, 16)
    key = keys.fold_in(keys.PRNGKey(11), 1)
    solver = tb.ProgrammedSolver.program(a, keys.generator(key), TCFG, 1,
                                         device="cpu")
    return a, key, solver, tb.plan_signature(16, 1, TCFG)


def test_port_store_roundtrip_bit_identical(tmp_path, programmed):
    a, key, solver, sig = programmed
    store = ProgramStore(str(tmp_path))
    store.save("m/0", solver, a, key, sig, extra={"trip": 0.5})
    assert store.has("m/0") and store.matrix_ids() == ["m_0"]
    restored, meta = store.restore("m/0", solver, a, key, sig)
    assert meta["trip"] == 0.5 and meta["n"] == 16
    assert restored.n == solver.n and restored.mode == solver.mode
    b = torch.from_numpy(_rhs(16)[:, 0])
    assert torch.equal(restored.solve(b), solver.solve(b))
    assert torch.equal(restored.solve(b, mode="reference"),
                       solver.solve(b, mode="reference"))
    store.save("m/0", solver, a, key, sig)
    assert latest_step(os.path.join(str(tmp_path), "m_0")) == 1


def test_stale_stores_raise_before_reading_arrays(tmp_path, programmed):
    a, key, solver, sig = programmed
    store = ProgramStore(str(tmp_path))
    store.save("m", solver, a, key, sig)
    with pytest.raises(StaleCheckpointError):
        store.restore("m", solver, _wishart(99, 16), key, sig)
    with pytest.raises(StaleCheckpointError):
        store.restore("m", solver, a, keys.fold_in(key, 1), sig)
    other = tb.plan_signature(16, 1, TCFG.with_(
        nonideal=TCFG.nonideal.__class__(sigma=0.05)))
    with pytest.raises(StaleCheckpointError):
        store.restore("m", solver, a, key, other)
    with pytest.raises(CheckpointError):
        store.restore("missing", solver, a, key, sig)


def test_truncated_store_raises_and_value_corruption_restores_wrong(
        tmp_path, programmed):
    a, key, solver, sig = programmed
    store = ProgramStore(str(tmp_path))
    store.save("t", solver, a, key, sig)
    store.corrupt("t", how="truncate")
    with pytest.raises(CheckpointCorruptionError):
        store.restore("t", solver, a, key, sig)
    store.save("v", solver, a, key, sig)
    store.corrupt("v", how="values")
    restored, _ = store.restore("v", solver, a, key, sig)    # no raise
    b = torch.from_numpy(_rhs(16)[:, 0])
    assert not torch.allclose(restored.solve(b), solver.solve(b), atol=1e-6)
    with pytest.raises(ValueError):
        store.corrupt("v", how="melt")


def test_value_corruption_writes_the_references_bytes(tmp_path):
    a, key, js = _jax_solver(16, 1)
    sig = jb.plan_signature(16, 1, JCFG)
    JStore(str(tmp_path / "j")).save("m", js, a, key, sig)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    JStore(str(tmp_path / "j")).corrupt("m", how="values")
    ProgramStore(str(tmp_path / "t")).corrupt("m", how="values")
    leaves = load_manifest(str(tmp_path / "t" / "m"), 0)["leaves"]
    for meta in leaves.values():
        x, y = (np.load(tmp_path / side / "m" / "step_00000000" /
                        meta["file"]) for side in ("j", "t"))
        assert np.array_equal(x, y)
