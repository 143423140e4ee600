"""The port's spans and counters (`repro_torch.tracing`): inert without a
profiler, nested with the right parents under one, a backward span whose
hooks hold the work between its inputs and output and leave a training
step's graph and values bitwise alone, the kernel build's counter and the
trainer's retries, and, on the card, device times that nest."""
import dataclasses
import subprocess
import time

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import _build
from repro_torch.launch.train import host_scale_config
from repro_torch.models import serve_step
from repro_torch.models import transformer as tr
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer
from repro_torch.tree import tree_leaves, tree_map

STEP_PARTS = ("train.batch", "train.microbatch", "train.accumulate",
              "train.optimizer", "train.host_read")


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


def _cfg(arch="stablelm-1.6b"):
    return dataclasses.replace(host_scale_config(get_config(arch)),
                               n_layers=2)


def _run(cfg):
    return RunConfig(model=cfg, mode="train", seq_len=32, global_batch=4,
                     microbatch=2, remat="dots")


def _profiled():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _node_names(t: torch.Tensor) -> set:
    seen, names, todo = set(), set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _loss_and_grads(cfg, gen_seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    params = tr.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 33), generator=gen,
                           device=device)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = tts.loss_fn(tree, batch, cfg, remat="dots")
    names = _node_names(loss)
    grads = torch.autograd.grad(loss, list(tree_leaves(tree)))
    return loss.detach(), grads, names


def test_without_a_profiler_nothing_runs_and_no_node_is_added(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(tracing, "_Pending", refuse)    # no hook
    assert tracing.span("x") is tracing.span("y")   # one shared null context
    cfg = _cfg()
    _loss_and_grads(cfg)
    hist = Trainer(cfg, _run(cfg), device="cpu", log_every=1000).run(1)
    assert hist["retries"] == [0]
    assert tracing.report() is None


def test_spans_nest_with_their_parents_under_a_profiler():
    cfg = _cfg()
    trainer = Trainer(cfg, _run(cfg), device="cpu", log_every=1000)
    trainer.run(1)                  # unprofiled: records nothing
    with _profiled():
        t0 = time.perf_counter()
        trainer.run(1)
        t1 = time.perf_counter()
    rep = tracing.report(window=(t0, t1))
    spans = rep["spans"]
    assert [r["name"] for r in rep["roots"]] == ["train.step"]
    assert t0 <= rep["roots"][0]["start_s"] <= rep["roots"][0]["end_s"] <= t1
    calls = {k: v["calls"] for k, v in spans.items()}
    assert calls == {
        "train.step": 1, "train.batch": 1, "train.microbatch": 2,
        "train.accumulate": 2, "train.optimizer": 1, "train.host_read": 1,
        "lm.embed": 2, "lm.head": 2, "lm.attn": 4, "lm.ffn": 4,
        "attn.core": 4,
        # remat "dots" recomputes each block's forward in its backward
        "lm.attn.recompute": 4, "lm.ffn.recompute": 4,
        "attn.core.recompute": 4, "attn.core.bwd": 4}
    want = {("attn.core", "lm.attn"),
            ("attn.core.recompute", "lm.attn.recompute"),
            ("attn.core.bwd", "train.microbatch")}
    want |= {(p, "train.step") for p in STEP_PARTS}
    want |= {(p, "train.microbatch") for p in (
        "lm.embed", "lm.head", "lm.attn", "lm.ffn", "lm.attn.recompute",
        "lm.ffn.recompute")}
    assert set(rep["nesting"]) == want
    # self time: a span's own less its children's, never below zero
    for name, s in spans.items():
        assert 0 <= s["self_ms"] <= s["device_ms"], name
    step = spans["train.step"]
    parts = sum(spans[p]["device_ms"] for p in STEP_PARTS)
    assert step["self_ms"] == pytest.approx(step["device_ms"] - parts)
    micro = spans["train.microbatch"]
    inside = sum(spans[p]["device_ms"] for p in (
        "lm.embed", "lm.head", "lm.attn", "lm.ffn", "lm.attn.recompute",
        "lm.ffn.recompute", "attn.core.bwd"))
    assert micro["self_ms"] == pytest.approx(micro["device_ms"] - inside)
    # a window before the step keeps none of its spans
    assert tracing.report(window=(t0 - 10, t0 - 5))["spans"] == {}


class _Tap(torch.autograd.Function):
    """Identity whose backward notes the spans open on its thread."""
    seen: list = []

    @staticmethod
    def forward(ctx, t, tag):
        ctx.tag = tag
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        _Tap.seen.append((ctx.tag, [r.name for r in tracing._STATE.stack()]))
        return g, None


def test_backward_span_holds_the_work_between_its_inputs_and_output():
    x = torch.randn(4, 8, requires_grad=True)
    _Tap.seen = []
    with _profiled():
        with tracing.span("step"):
            a, b = _Tap.apply(x, "input a"), _Tap.apply(x, "input b")
            work = _Tap.apply(a * b, "work")
            tracing.backward_span("work.bwd", (a, b), work)
            _Tap.apply(work, "after").sum().backward()
    inside = {tag: "work.bwd" in open_ for tag, open_ in _Tap.seen}
    assert inside == {"after": False, "work": True, "input a": False,
                      "input b": False}
    rep = tracing.report()
    assert rep["spans"]["work.bwd"]["calls"] == 1
    assert rep["nesting"] == [("work.bwd", "step")]
    for i in range(3):              # each step's spans are kept till reset
        with _profiled(), tracing.span("step"):
            pass
        assert tracing.report()["spans"]["step"]["calls"] == i + 2


def test_markers_leave_loss_and_gradients_bitwise_equal():
    cfg = _cfg()
    loss, grads, names = _loss_and_grads(cfg)
    with _profiled():
        loss_p, grads_p, names_p = _loss_and_grads(cfg)
    assert names_p == names         # hooks, no node
    assert torch.equal(loss, loss_p)
    assert len(grads) == len(grads_p)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_p))
    assert tracing.report()["spans"]["attn.core.bwd"]["calls"] == 2


def test_prefill_spans_cover_the_request():
    cfg = _cfg("glm4-9b")
    params = tr.init_params(torch.Generator().manual_seed(1), cfg)
    step = serve_step.make_prefill_step(cfg)
    ids = torch.randint(0, cfg.vocab, (1, 48), generator=torch.Generator()
                        .manual_seed(2))
    with torch.no_grad():
        want, _ = step(params, {"tokens": ids})
        with _profiled():
            got, _ = step(params, {"tokens": ids})
    assert torch.equal(want, got)
    spans = tracing.report()["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {
        "serve.prefill": 1, "lm.embed": 1, "lm.attn": 2, "attn.core": 2,
        "lm.ffn": 2, "lm.head": 1}
    parts = sum(spans[p]["device_ms"] for p in (
        "lm.embed", "lm.attn", "lm.ffn", "lm.head"))
    assert parts <= spans["serve.prefill"]["device_ms"]


def test_trainer_counts_its_retries():
    cfg = _cfg()
    trainer = Trainer(cfg, _run(cfg), device="cpu", log_every=1000)
    real, failed = trainer.step_fn, []

    def flaky(state, batch):
        if not failed:
            failed.append(1)
            raise RuntimeError("transient")
        return real(state, batch)
    trainer.step_fn = flaky
    hist = trainer.run(2)
    assert hist["retries"] == [1, 0]


class _FakeNvcc:
    """A compile that writes its output file, as nvcc would."""
    calls = 0

    def __init__(self, cmd, **kwargs):
        type(self).calls += 1
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\0")
        self.returncode = 0

    def communicate(self):
        return "ptxas info: fake", None


def test_kernel_build_counts_a_build_and_no_warm_load(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    _FakeNvcc.calls = 0
    _build.load("flash_attention")
    counters = tracing.report()["counters"]
    assert list(counters) == ["kernel.build_s"] and _FakeNvcc.calls == 1
    assert counters["kernel.build_s"] > 0
    _build._LIBS.clear()            # a new process, the directory warm
    _build.load("flash_attention")
    assert tracing.report()["counters"] == counters
    assert _FakeNvcc.calls == 1


@pytest.mark.cuda
def test_device_times_on_the_card_nest():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = _cfg()
    trainer = Trainer(cfg, _run(cfg), device="cuda", log_every=1000)
    trainer.run(1)
    gcfg = _cfg("glm4-9b")
    params = tr.init_params(torch.Generator("cuda").manual_seed(1), gcfg)
    step = serve_step.make_prefill_step(gcfg)
    ids = torch.randint(0, gcfg.vocab, (1, 64), device="cuda")

    def prefill():
        with torch.no_grad():
            step(params, {"tokens": ids})

    prefill()
    slack = 1e-2                    # ms: the events' resolution, summed
    for root, parts, work in (
            ("train.step", STEP_PARTS, lambda: trainer.run(1)),
            ("serve.prefill", ("lm.embed", "lm.attn", "lm.ffn", "lm.head"),
             prefill)):
        tracing.reset()
        with _profiled():
            work()
        rep = tracing.report()
        spans = rep["spans"]
        assert all(s["device_ms"] > 0 for s in spans.values()), spans
        inner = sum(spans[p]["device_ms"] for p in parts)
        assert inner <= spans[root]["device_ms"] + slack, (root, spans)
        for name, s in spans.items():
            assert s["self_ms"] >= -slack, (name, s)
        if root == "train.step":
            assert spans["attn.core.bwd"]["calls"] == 4
            # the backward's spans run on the engine's thread, under the
            # microbatch that waits on it
            assert ("attn.core.bwd", "train.microbatch") in rep["nesting"]
            assert ("lm.attn.recompute", "train.microbatch") in \
                rep["nesting"]
