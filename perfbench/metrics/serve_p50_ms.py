"""The median latency of the serving window's requests, from when each was
due to when its npy response was read (a failed one infinitely slow).
Above the knee the backlog grows all through the window, so it swings
with the smallest change of the service's rate."""


def read(r: dict):
    return r["layer"].get("p50_ms")
