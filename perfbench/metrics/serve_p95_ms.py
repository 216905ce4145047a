"""The 95th percentile of the serving window's latencies, as
``serve_p50_ms`` takes them: above the knee, the wait of the requests due
late in the window behind the backlog."""


def read(r: dict):
    return r["layer"].get("p95_ms")
