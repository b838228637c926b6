"""``idle_share.card``: share of the traced stretch of resident steps
in which nothing ran on the card (no kernel, copy or set)."""


def read(run):
    t = run.get("trace")
    if run["loop"] != "resident" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
