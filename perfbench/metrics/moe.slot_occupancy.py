"""Per cent of the expert slots a rank computes (E times the capacity of
the global batch) that kept tokens fill, over the window's steps and the
MoE blocks: from the program's routed fractions and ``capacity()``, read by
forward hooks in the traced run only."""


def read(r: dict):
    share = r["layer"].get("slot_occupancy")
    return None if share is None else 100.0 * share
