"""Microseconds a step the host spends in ``model.train_step_n`` (the
benchmark's span around each call, until it returns: the graph's inputs
copied, the learning-rate slots filled, the launch), over the window."""


def read(r: dict):
    spans = r["layer"].get("spans")
    return None if not spans else 1e6 * spans["dispatch"]
