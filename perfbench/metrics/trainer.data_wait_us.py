"""Microseconds a step the trainer loop waits for its next chunk from the
prefetcher (the benchmark's span around each fetch, over the window)."""


def read(r: dict):
    spans = r["layer"].get("spans")
    return None if not spans else 1e6 * spans["data_wait"]
