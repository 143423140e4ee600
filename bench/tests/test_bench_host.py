"""The drivers, the readers and the reference end to end on the host, at
the program's host scale (`launch.train.host_scale_config`, sequences cut
to 64 tokens): each cell's result line, the import check in a fresh
process, the runs that must print no result, and the output check
failing under the faults a cell can have and under its control."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import core
import run

CELLS = [w["name"] for w in core.load_spec()["workloads"]]
SEED = 2 ** 31 + 77
TRAIN = "stablelm-1.6b.train_4k"
PREFILL = ["glm4-9b.prefill_32k"]


def host_run(cell, trace=False, seconds=0.3):
    return run.run_cell(cell, SEED, seconds, trace, "cpu", host_scale=True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_and_its_line_parses(cell):
    out = json.loads(json.dumps(host_run(cell)))
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] >= 1
    c = core.Cell(cell)
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == set(c.limits)


@pytest.mark.parametrize("cell", [TRAIN, PREFILL[0]])
def test_traced_run_on_the_host_reports_no_device_number(cell):
    out = host_run(cell, trace=True)
    # no card: no device time, so no share, no idle and no peak is read
    assert out["metrics"] == {}
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [{b!r}, {s!r}]; import run, core; "
            "run.run_cell({c!r}, 5, 0.2, False, 'cpu', host_scale=True); "
            "print(core.forbidden_modules())").format(
                b=str(core.BENCH), s=str(core.ROOT / "src"), c=PREFILL[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(core.BENCH / "run.py"), "--workload", TRAIN,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=core.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [{b!r}]; import run; "
            "print(run.run_cell({c!r}, 5, 0.2, False, 'cpu', "
            "host_scale=True))").format(b=str(tmp_path / "bench"), c=TRAIN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


# -- faults planted under the timed path: `correct` must come out false --

def _train_fault(monkeypatch, fault):
    from repro_torch.train import trainer
    real = trainer.make_train_step

    def broken(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrong(state, batch):
            if fault == "unchanged":
                return state, step(state, batch)[1]
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)
        return wrong
    monkeypatch.setattr(trainer, "make_train_step", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_fail_the_check(monkeypatch, fault):
    _train_fault(monkeypatch, fault)
    out = host_run(TRAIN)
    assert out["correct"] is False, out["checks"]


def _prefill_fault(monkeypatch, fault):
    from repro_torch.models import serve_step
    real = serve_step.make_prefill_step

    def broken(cfg, *args, **kwargs):
        step = real(cfg, *args, **kwargs)

        def wrong(params, batch):
            tok, cache = step(params, batch)
            if fault == "token":
                return (tok + 1) % cfg.vocab, cache
            return tok, {"blocks": {"b0": {
                k: v.zero_() for k, v in cache["blocks"]["b0"].items()}}}
        return wrong
    monkeypatch.setattr(serve_step, "make_prefill_step", broken)


@pytest.mark.parametrize("fault", ["token", "cache"])
@pytest.mark.parametrize("cell", PREFILL)
def test_prefill_faults_fail_the_check(monkeypatch, cell, fault):
    _prefill_fault(monkeypatch, fault)
    out = host_run(cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    """The float8 control in the program's place, and each fault the
    driver plants there (training: half the batch), come out not correct
    by the same `correct` as a run's output."""
    out = run.control_cell(cell, SEED, "cpu", host_scale=True)
    assert out["control"]["correct"] is False, out
    assert all(f["correct"] is False for f in out["faults"].values()), out
