"""The port's HTTP sampler server (igm_tpu_torch/tools/serve.py) on the CPU:
an artifact exported in the test, served in this process, driven by real
HTTP requests.  Every npy response is the batch ``python -m
igm_tpu_torch.cli`` draws at that seed, bit for bit, served alone or among
concurrent requests; /stats keeps ``igm_tpu``'s keys and formulas
(``tools/serve.py`` ``SamplerService.stats``, held on the same latencies)
and adds the tracing registry's queue, encoding and sampler-step keys; the
spans of one request share its request id."""
import io
import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch.cli import sample_main  # noqa: E402
from igm_tpu_torch.config import compose, instantiate  # noqa: E402
from igm_tpu_torch.tools import export as ex  # noqa: E402
from igm_tpu_torch.tools import serve as sv  # noqa: E402

torch.set_num_threads(1)

TINY = ["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1,2]",
        "model.timesteps=6"]
SAMPLER = ["--sampler", "dpm", "--steps", "3"]
N = 2
# igm_tpu's /stats keys, and the port's span keys beside them
STATS = {"requests", "p50_ms", "p95_ms", "p99_ms", "batch_per_request", "samples_per_sec"}
SPAN_STATS = {"queue_p50_ms", "queue_p95_ms", "encode_p50_ms", "sampler_step_host_ms"}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cfg = compose(REPO / "configs", [*TINY, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    model.init_params(11)
    weights = tmp / "w.pt"
    torch.save(model.modules["denoise"].state_dict(), weights)
    art = tmp / "ddpm.pt"
    ex.main([*TINY, "--weights", str(weights), "--n", str(N), *SAMPLER, "--out", str(art),
             "--device", "cpu"])
    return art, weights


@pytest.fixture(scope="module")
def server(artifact):
    httpd = sv.serve(str(artifact[0]), "127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd.service
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body, fmt="npy"):
    req = urllib.request.Request(url, data=json.dumps({**body, "format": fmt}).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _fetch(base, seed):
    with _post(f"{base}/sample", {"seed": seed}) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "application/x-npy"
        return np.load(io.BytesIO(r.read()))


def test_healthz_stats_and_unknown_routes(server):
    base, _ = server
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
        h = json.loads(r.read())
    assert h["ok"] and h["n"] == N and h["sampler"] == "dpm" and h["steps"] == 3
    assert h["out_shape"] == [[N, 32, 32, 3]] and h["device"] == "cpu"
    assert h["model"] == "igm_tpu.models.ddpm.DDPM"
    _fetch(base, 0)
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
        s = json.loads(r.read())
    assert set(s) == STATS | SPAN_STATS
    assert s["requests"] >= 1 and 0 < s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert s["batch_per_request"] == N and s["samples_per_sec"] > 0
    for call in (lambda: urllib.request.urlopen(f"{base}/nope", timeout=60),
                 lambda: _post(f"{base}/nope", {"seed": 0})):
        with pytest.raises(urllib.error.HTTPError) as err:
            call()
        assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:     # the exception's text comes back
        _post(f"{base}/sample", {"seed": "seven"})
    assert err.value.code == 500 and b"ValueError" in err.value.read()


def test_npy_is_deterministic_and_equals_the_sampling_cli(server, artifact, tmp_path):
    base, _ = server
    a, b, c = _fetch(base, 7), _fetch(base, 7), _fetch(base, 8)
    assert a.shape == (N, 32, 32, 3) and a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    want = sample_main([*TINY, "--weights", str(artifact[1]), "--n", str(N), "--seed", "7",
                        *SAMPLER, "--device", "cpu", "--out", str(tmp_path / "cli.png")])
    np.testing.assert_array_equal(a, want.numpy())


def test_png(server):
    base, _ = server
    with _post(f"{base}/sample", {"seed": 1}, fmt="png") as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        data = r.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image
    with Image.open(io.BytesIO(data)) as img:
        assert img.size == (2 + N * 34, 2 + 34)


def test_concurrent_requests_equal_serial_ones(server):
    base, _ = server
    seeds = [3, 5, 3, 7, 5, 7, 3, 5]
    serial = {s: _fetch(base, s) for s in set(seeds)}
    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(lambda s: _fetch(base, s), seeds))
    for seed, got in zip(seeds, results):
        np.testing.assert_array_equal(got, serial[seed])


def test_bench_line(artifact, capsys):
    sv.main([str(artifact[0]), "--bench", "3", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == STATS | SPAN_STATS | {"wall_s", "http_requests_per_sec"}
    assert stats["requests"] == 3 and stats["http_requests_per_sec"] > 0


@pytest.mark.parametrize("latencies", [[], [12.5], [3.0, 1.0, 2.0], list(np.linspace(5, 95, 37))],
                         ids=["none", "one", "three", "many"])
def test_stats_match_igm_tpus_formulas(server, latencies):
    """The same latency list through both services' ``stats``."""
    from tools.serve import SamplerService as Reference
    _, svc = server
    ref = object.__new__(Reference)
    ref.latencies_ms, ref.meta = list(latencies), {"n": N}
    port = object.__new__(sv.SamplerService)
    port.latencies_ms, port.meta = list(latencies), dict(svc.meta)
    got, want = port.stats(), ref.stats()
    assert set(got) == set(want) | SPAN_STATS
    assert {k: got[k] for k in want} == want


def test_span_stats_after_three_requests(server):
    """Three requests through HTTP: /stats' span keys read the registry's
    ``server.queue``, ``server.encode`` and ``sampler.step`` records."""
    base, _ = server
    for seed in range(3):
        _fetch(base, seed)
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
        s = json.loads(r.read())
    assert 0 <= s["queue_p50_ms"] <= s["queue_p95_ms"]
    assert s["encode_p50_ms"] > 0 and s["sampler_step_host_ms"] > 0
    from igm_tpu_torch.core import trace
    spans = trace.spans()
    assert spans["sampler.step"]["count"] >= 3 * 3         # three steps a request
    assert spans["sampler.network"]["count"] == spans["sampler.step"]["count"]
    assert spans["server.queue"]["count"] >= 3 and spans["server.encode"]["count"] >= 3


def test_spans_of_one_request_share_its_id(server):
    """A request's spans, on its handler thread, carry one request id that
    no other request's carry, and lie inside its ``server.request``."""
    from igm_tpu_torch.core import trace
    base, _ = server
    _fetch(base, 4)
    records = trace.records()
    last = max((r for r in records if r["name"] == "server.request"),
               key=lambda r: r["end_ns"])
    mine = [r for r in records if r["request"] == last["request"]]
    assert last["request"] is not None
    assert {r["name"] for r in mine} == {"server.request", "server.queue", "server.service",
                                         "server.encode", "sampler.step", "sampler.network"}
    assert [r["name"] for r in mine].count("sampler.step") == 3
    assert all(r["thread"] == last["thread"] for r in mine)
    assert all(last["start_ns"] <= r["start_ns"] <= r["end_ns"] <= last["end_ns"] for r in mine)
    parents = {r["name"]: r["parent"] for r in mine}
    assert parents["server.queue"] == parents["server.encode"] == "server.request"
    assert parents["sampler.network"] == "sampler.step"
    assert parents["server.request"] is None
