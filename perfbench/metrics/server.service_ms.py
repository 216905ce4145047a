"""The sampler service's own clock: the median of its per-request times
(the sampler call and the copy of its output to the host, inside the
service's lock, without the queue before it), as ``GET /stats`` gives it
after the window."""


def read(r: dict):
    return r["layer"].get("service_p50_ms")
