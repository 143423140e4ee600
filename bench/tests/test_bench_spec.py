"""`BENCHMARK.json` against the benchmark's contract, every name leading
to its files, the import check, and the frozen work counts held to
hand-worked values."""
import math
import re
import statistics

import pytest

import core

SPEC = core.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["bench"]
    assert len(SPEC["command"]) <= 32
    for word in SPEC["command"][1:]:
        assert word.startswith("bench/") or not word.endswith(".py")
    assert len(core.json.dumps(SPEC)) <= 64 * 1024


def test_names_and_units():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + \
        SPEC["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:        # each cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], m["layer"])
    for w in SPEC["workloads"]:
        cell = core.Cell(w["name"], SPEC)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = core.Cell(cell, SPEC)
    assert c.chips == 1
    assert (core.ROOT / c.config_entry["file"]).is_file()
    assert c.config_entry["file"].startswith("bench/")
    assert hasattr(c.driver(), "Driver")
    for m in c.end_to_end + c.per_layer:
        assert callable(core.reader(m["name"]).read)
    shapes = c.shapes()
    assert {"n_layers", "d_model", "n_heads", "kv_heads", "head_dim",
            "d_ff", "vocab"} <= set(shapes)
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_configs_are_used_and_reduce_no_width():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert used == {c["name"] for c in SPEC["configs"]}
    assert len(files) == len(set(files))
    widths = re.compile(r"(hidden|intermediate|ffn|_dim$|_rank$|head|"
                        r"expert|latent|state|channels|size)")
    for c in SPEC["configs"]:
        body = core.load_json(core.ROOT / c["file"])
        assert body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
        for key in c["reduced"]:
            assert not widths.search(key), key
            assert body["published"][key] != body[key]


def test_import_check_compares_top_level_names_whole():
    mods = dict.fromkeys(["repro_torch", "repro_torch.models",
                          "reprox", "jaxtyping", "numpy"])
    assert core.forbidden_modules(mods) == []
    mods.update(dict.fromkeys(["repro", "repro.core.blockamc", "jax.numpy",
                               "jaxlib", "flax.linen", "benchmarks.run"]))
    assert core.forbidden_modules(mods) == [
        "benchmarks.run", "flax.linen", "jax.numpy", "jaxlib", "repro",
        "repro.core.blockamc"]


def test_train_step_flops_hand_worked():
    mfu = core.reader("train_mfu")
    sh = core.Cell("stablelm-1.6b.train_4k", SPEC).shapes()
    # 6 x 1,644,267,520 parameters x 32768 tokens
    # + 6 x 4096 x 2048 x 32768 x 24 for causal attention
    assert mfu.n_params(sh) == 1_644_267_520
    assert math.isclose(mfu.step_flops(sh, 8, 4096), 3.6286e14, rel_tol=1e-4)


def test_flash_bound_hand_worked():
    roof = core.reader("flash_roofline.prefill")
    # 4 x 32 x 128 x (8192 x 8193 / 2) FLOPs at 989 TFLOP/s = 0.5559 ms
    assert math.isclose(roof.call_bound_s(32, 8192, 128, "bfloat16"),
                        0.5559e-3, rel_tol=2e-4)
    # at 512 tokens the bytes bound it: 4 x 32 x 512 x 128 x 2 / 3.35e12
    assert math.isclose(roof.call_bound_s(32, 512, 128, "bfloat16"),
                        4 * 32 * 512 * 128 * 2 / 3.35e12)


def test_prefill_flops_hand_worked():
    mfu = core.reader("prefill_mfu")
    sh = core.Cell("glm4-9b.prefill_32k", SPEC).shapes()
    s = 32768
    weights = 40 * (2 * 4096 * 4096 + 2 * 4096 * 256 + 3 * 4096 * 13696)
    want = 2 * s * weights + 2 * 4096 * 151552 + 40 * 2 * 4096 * s * (s + 1)
    assert mfu.prompt_flops(sh, s) == want
    assert math.isclose(want, 8.87e14, rel_tol=5e-3)


def test_seeds_and_weights_repeat():
    import torch
    big = 2 ** 31 + 12345
    assert core.sub_seed(big, 1) == core.sub_seed(big, 1)
    assert core.sub_seed(big, 1) != core.sub_seed(big + 1, 1)
    sh = dict(n_layers=2, d_model=16, n_heads=2, kv_heads=1, head_dim=8,
              d_ff=32, vocab=300)
    a = core.make_weights(sh, big, "cpu", torch.float32)
    b = core.make_weights(sh, big, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["embed"].shape == (512, 16) and a["wk"].shape == (2, 16, 8)
    tree = core.program_params(a)
    assert tree["blocks"]["b0"]["mix"]["wq"] is a["wq"]
    assert statistics.pstdev(a["wq"].flatten().tolist()) == \
        pytest.approx(16 ** -0.5, rel=0.1)
