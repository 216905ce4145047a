"""The port's tracing registry (igm_tpu_torch/core/trace.py) on the CPU:
spans' nesting and self time, per-thread rings, request ids, counters,
the placement of every thread's spans on a ``torch.profiler`` timeline
(against ``record_function`` anchors of the same regions) and in the
Chrome trace the trainer writes, the profiling tools' idle gaps, the
trainer's ``trace/*`` scalars, and the benchmark's readers of the
registry (``perfbench/metrics``) on a hand-filled registry.  A CUDA case
holds a replayed graph's work counters."""
import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.core import trace  # noqa: E402

torch.set_num_threads(1)

# the profiler's timeline against the spans' clock: a span opened right
# inside a record_function range lands within this of it
ANCHOR_US = 200.0


def _delta(before: dict, name: str) -> dict:
    after = trace.spans()[name]
    was = before.get(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
    return {k: after[k] - was[k] for k in ("count", "total_s", "self_s")}


def test_nesting_parents_and_self_time():
    before = trace.spans()
    with trace.span("t.outer"):
        time.sleep(0.002)
        with trace.span("t.inner"):
            time.sleep(0.004)
        with trace.span("t.inner"):
            with trace.span("t.inner"):        # the same name nested in itself
                time.sleep(0.001)
    outer, inner = _delta(before, "t.outer"), _delta(before, "t.inner")
    assert outer["count"] == 1 and inner["count"] == 3
    assert inner["self_s"] < inner["total_s"]           # the nested one is a child
    children = [r for r in trace.records() if r["name"] == "t.inner"][-3:]
    assert [r["parent"] for r in children] == ["t.outer", "t.inner", "t.outer"]
    direct = sum(r["end_ns"] - r["start_ns"] for r in children if r["parent"] == "t.outer")
    assert outer["self_s"] == pytest.approx(outer["total_s"] - direct * 1e-9, abs=1e-9)
    assert outer["self_s"] >= 0.002 and outer["total_s"] >= 0.007
    last = [r for r in trace.records() if r["name"] == "t.outer"][-1]
    assert last["parent"] is None and last["thread"] == threading.get_native_id()
    s = trace.spans()["t.inner"]
    assert 0 < s["p50_s"] <= s["p95_s"]


def test_an_exception_closes_its_span():
    before = trace.spans()
    with pytest.raises(KeyError):
        with trace.span("t.raises"):
            raise KeyError("x")
    with trace.span("t.after"):
        pass
    assert _delta(before, "t.raises")["count"] == 1
    assert [r for r in trace.records() if r["name"] == "t.after"][-1]["parent"] is None


def test_threads_keep_rings_of_their_own_and_leave_them_when_done():
    """Two threads' spans carry their own thread ids; a thread started
    after one has ended takes its ring over, so the rings stay as many as
    the threads alive at once."""
    barrier = threading.Barrier(2)
    ids = {}

    def work(tag):
        barrier.wait()
        with trace.span(f"t.thread_{tag}"):
            ids[tag] = threading.get_native_id()
            barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    by_name = {r["name"]: r["thread"] for r in trace.records()}
    assert by_name["t.thread_a"] == ids["a"] != ids["b"] == by_name["t.thread_b"]

    def later():
        with trace.span("t.later"):
            pass

    rings = len(trace._states)
    for _ in range(3):                    # one at a time: each takes a finished one's
        t = threading.Thread(target=later)
        t.start()
        t.join()
    assert len(trace._states) == rings
    assert trace.spans()["t.thread_a"]["count"] >= 1      # the totals outlive the thread


def test_spans_of_one_request_share_its_id():
    with trace.request() as rid:
        with trace.span("t.req"):
            with trace.request(77):
                with trace.span("t.req_inner"):
                    pass
            with trace.span("t.req_tail"):
                pass
    with trace.span("t.no_req"):
        pass
    last = {r["name"]: r["request"] for r in trace.records()}
    assert isinstance(rid, int)
    assert last["t.req"] == last["t.req_tail"] == rid
    assert last["t.req_inner"] == 77 and last["t.no_req"] is None
    with trace.request() as other:
        assert other != rid


def test_counters_work_counters_and_a_device_counter():
    from igm_tpu_torch.core.graphs import launch_counters, work_counts
    before = trace.counters()
    trace.count("t.host", 2)
    trace.count("t.host")
    trace.count("t.work", 5, work=True)
    got = trace.counters()
    assert got["t.host"] - before.get("t.host", 0) == 3
    assert "t.host" not in trace.work_counts() and "t.work" in trace.work_counts()
    counts = work_counts()       # what a StepGraph walks: the wrappers' launches and these
    assert counts["t.work"] == got["t.work"]
    assert all(counts[c] == c.launches for c in launch_counters())
    lin = torch.nn.Linear(2, 2)
    c = trace.device_counter("t.device", 3, "cpu")
    assert trace.device_counter("t.device", 3, "cpu") is c
    c[1].add_(lin.weight.sum().detach() * 0 + 4)
    del lin                                   # a counter outlives what added to it
    got = trace.snapshot()["counters"]["t.device"]
    assert got[1] - before.get("t.device", [0, 0, 0])[1] == 4 and len(got) == 3


def _anchored_profile():
    """A profiled run with a main-thread span inside a ``record_function``
    anchor, and a second thread's span around another anchor the main
    thread opens while the span is open."""
    from torch.profiler import ProfilerActivity, profile, record_function
    opened, closed = threading.Event(), threading.Event()

    def other():
        with trace.span("t.other_thread"):
            opened.set()
            closed.wait(10)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("anchor_main"):
            with trace.span("t.main_thread"):
                time.sleep(0.003)
        worker = threading.Thread(target=other)
        worker.start()
        opened.wait(10)
        with record_function("anchor_other"):
            time.sleep(0.003)
        closed.set()
        worker.join()
        time.sleep(0.001)
    return prof


def test_on_timeline_places_every_threads_spans_beside_the_profilers():
    _anchored_profile()                                 # the first call warms up
    prof = _anchored_profile()
    anchors = {e.name: e.time_range for e in prof.events() if e.name.startswith("anchor_")}
    placed = trace.on_timeline(prof)
    main = [r for r in placed if r["name"] == "t.main_thread"][-1]
    other = [r for r in placed if r["name"] == "t.other_thread"][-1]
    a = anchors["anchor_main"]
    assert abs(main["start_us"] - a.start) < ANCHOR_US
    assert abs(main["end_us"] - a.end) < ANCHOR_US
    assert main["thread"] == threading.get_native_id() != other["thread"]
    b = anchors["anchor_other"]           # the other thread's span holds this anchor
    assert other["start_us"] < b.start + ANCHOR_US and other["end_us"] > b.end - ANCHOR_US
    assert b.start - other["start_us"] < 1e5 and other["end_us"] - b.end < 1e5
    assert all(r["end_us"] >= 0 for r in placed)


def test_chrome_trace_gets_the_spans(tmp_path):
    prof = _anchored_profile()
    path = tmp_path / "t.json"
    trace.export_chrome_trace(prof, str(path))
    events = json.loads(path.read_text())["traceEvents"]
    anchor = [e for e in events if e.get("name") == "anchor_main" and e.get("ph") == "X"][0]
    span = [e for e in events if e.get("cat") == "igm_trace"
            and e["name"] == "t.main_thread"][-1]
    assert abs(span["ts"] - anchor["ts"]) < ANCHOR_US
    assert abs(span["dur"] - anchor["dur"]) < 2 * ANCHOR_US
    names = [e for e in events if e.get("ph") == "M" and e.get("tid") == span["tid"]]
    assert names and names[0]["args"]["name"].startswith("spans: ")


def test_idle_gaps_are_put_down_to_the_innermost_span():
    from igm_tpu_torch.tools.profiling import idle_gaps
    busy = [(0, 10), (5, 20), (30, 40), (100, 110), (111, 112)]
    records = [{"name": "a.outer", "start_us": 50, "end_us": 105, "thread": 1},
               {"name": "a.inner", "start_us": 60, "end_us": 80, "thread": 1},
               {"name": "b.worker", "start_us": 0, "end_us": 200, "thread": 2}]
    gaps = idle_gaps(busy, records)
    assert [(g["start_ms"] * 1e3, g["ms"] * 1e3) for g in gaps] == \
        [(40, 60), (20, 10), (110, 1)]
    assert [g["span"] for g in gaps] == ["a.inner", "b.worker", "b.worker"]
    assert gaps[0]["threads"] == ["a.inner", "b.worker"]
    assert idle_gaps(busy, [])[0]["span"] == "none"
    assert len(idle_gaps([(2 * i, 2 * i + 1) for i in range(30)], [])) == 10


def test_trainer_trace_scalars_are_the_epochs_deltas():
    from igm_tpu_torch.core.trainer import trace_scalars
    before = {"spans": {"a.x": {"count": 2, "total_s": 0.5}},
              "counters": {"c.n": 3, "c.v": [1.0, 2.0]}}
    after = {"spans": {"a.x": {"count": 6, "total_s": 0.9}, "a.y": {"count": 1, "total_s": 0.2},
                       "a.same": {"count": 0, "total_s": 0.0}},
             "counters": {"c.n": 10, "c.v": [4.0, 2.0], "c.new": 5}}
    assert trace_scalars(before, after) == pytest.approx(
        {"trace/a.x_ms": 100.0, "trace/a.y_ms": 200.0, "trace/c.n": 7, "trace/c.v/0": 3.0,
         "trace/c.v/1": 0.0, "trace/c.new": 5})


class _Recorder:
    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        self.scalars = {}

    def log_scalars(self, metrics, step):
        self.scalars.update(metrics)

    def log_scalar(self, tag, value, step):
        self.scalars[tag] = value

    def log_image(self, *a, **k):
        pass

    def log_hyperparams(self, params):
        pass

    def finalize(self):
        pass


def test_fit_logs_trace_scalars_and_writes_spans_into_its_profile(tmp_path, monkeypatch):
    """A tiny fit with ``trainer.profile=true``: the epoch's ``trace/*``
    scalars, and the prefetch thread's spans in the Chrome trace beside
    the main thread's."""
    from igm_tpu_torch.config import compose, instantiate
    monkeypatch.chdir(tmp_path)
    cfg = compose(REPO / "configs", [
        "experiment=vae/mnist_mlp", "datamodule.width=8", "datamodule.height=8",
        "datamodule.batch_size=8", "model.latent_dim=2", "networks.encoder.hidden_dims=[8]",
        "networks.decoder.hidden_dims=[8]", "trainer.limit_train_batches=3",
        "trainer.limit_val_batches=0", "trainer.enable_checkpointing=False",
        "trainer.max_epochs=1", "trainer.profile=true", "trainer.steps_per_execution=1",
        f"datamodule.data_dir={tmp_path / 'no_data'}", "print_config=False"])
    logger = _Recorder(str(tmp_path / "tb"))
    trainer = instantiate(cfg.trainer, logger=logger, callbacks=[])
    trainer.fit(instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu"),
                instantiate(cfg.datamodule))
    assert logger.scalars["trace/train.steps"] == 3
    assert logger.scalars["trace/train.step_n_ms"] > 0
    assert logger.scalars["trace/loader.wait_ms"] >= 0
    assert "perf/achieved_tflops" not in logger.scalars
    events = json.loads(Path(trainer.profile_path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "igm_trace"]
    threads = {e["name"]: e["tid"] for e in spans}
    assert {"train.step_n", "loader.wait", "loader.gather", "loader.stage",
            "trainer.metrics"} <= set(threads)
    assert threads["loader.stage"] != threads["train.step_n"]


# ------------------------------------------------ the benchmark's readers
READ = {   # reader -> (spans, counters, the number it reads)
    "loader.gather_ms": ({"loader.gather": (4, 0.02)}, {}, 5.0),
    "loader.stage_ms": ({"loader.stage": (4, 0.008)}, {}, 2.0),
    "loader.wait_us": ({"loader.wait": (5, 0.001)}, {"train.steps": 10}, 100.0),
    "graphs.launch_us": ({"graphs.launch": (9, 0.08)}, {"train.steps": 10}, 8000.0),
    "graphs.host_us": ({"train.step_n": (10, 1.5), "graphs.launch": (9, 0.08),
                        "graphs.capture": (1, 1.0)}, {"train.steps": 10}, 42000.0),
    "graphs.captures": ({}, {"graphs.captures": 2}, 2.0),
    "moe.slot_fill": ({}, {"moe.tokens": [100.0, 90.0, 120.0]}, 75.0),
    "mesh.collective_mb": ({}, {"mesh.collective_bytes": 2.5e9, "train.steps": 10}, 250.0),
}


def _reader(name: str):
    from perfbench.harness import bench
    return bench.metric_reader(name)


@pytest.mark.parametrize("name", list(READ))
def test_reader_reads_a_hand_filled_registry(name, monkeypatch):
    spans, counters, want = READ[name]
    monkeypatch.setattr(trace, "spans", lambda: {
        k: {"count": n, "total_s": t, "self_s": t, "p50_s": None, "p95_s": None}
        for k, (n, t) in spans.items()})
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    monkeypatch.setattr(trace, "snapshot", lambda: {"spans": trace.spans(),
                                                    "counters": trace.counters()})
    assert _reader(name).read({}) == pytest.approx(want)
    monkeypatch.setattr(trace, "spans", lambda: {})          # nothing recorded
    monkeypatch.setattr(trace, "counters", lambda: {})
    assert _reader(name).read({}) is None


@pytest.mark.parametrize("name", list(READ))
def test_reader_without_the_registry_reads_nothing(name, monkeypatch):
    """A program without ``core/trace.py`` (the parent of the change that
    brought it) gives no number and no error."""
    import igm_tpu_torch.core as core
    monkeypatch.setitem(sys.modules, "igm_tpu_torch.core.trace", None)
    monkeypatch.delattr(core, "trace")
    with pytest.raises(ImportError):
        from igm_tpu_torch.core import trace as _  # noqa: F401
    assert _reader(name).read({}) is None


def test_every_reader_is_a_benchmark_metric():
    bmk = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bmk["per_layer"]}
    for name in READ:
        assert entries[name]["source"] in ("program_span", "program_counter")
        assert (REPO / "perfbench" / "metrics" / f"{name}.py").is_file()


# ------------------------------------------------------------------ CUDA
@pytest.mark.cuda
def test_a_replayed_graph_counts_its_captures_work_again():
    """A graph that issues a collective's host call (counted by
    ``parallel/mesh.py`` ``counted``) and launches a hand kernel: the
    capture's counts are taken back and added again at every replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from igm_tpu_torch.core.graphs import StepGraph
    from igm_tpu_torch.ops.groupnorm import group_norm_mish
    from igm_tpu_torch.parallel.mesh import counted

    x = torch.randn(2, 8, 8, 32, device="cuda", dtype=torch.bfloat16)
    scale = torch.ones(32, device="cuda")
    bias = torch.zeros(32, device="cuda")

    def step(x):
        counted(x)
        return group_norm_mish(x, scale, bias, 8)

    graph = StepGraph(step)
    names = ("mesh.collectives", "mesh.collective_bytes")

    def counts():
        work = trace.work_counts()
        return [work.get(k, 0) for k in names] + [group_norm_mish.launches]

    c0 = counts()
    graph(x)                             # warm-up (counted) and capture (taken back)
    c1 = counts()
    assert [b - a for a, b in zip(c0, c1)] == [1, x.numel() * 2, 1]
    for i in range(3):
        graph(x)
    c2 = counts()
    assert [b - a for a, b in zip(c1, c2)] == [3, 3 * x.numel() * 2, 3]
    assert set(graph.deltas) == {*names, group_norm_mish}    # the moved counts alone
    assert trace.counters()["graphs.captures"] >= 1
    assert trace.spans()["graphs.launch"]["count"] >= 3
