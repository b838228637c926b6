"""``served_channels``: stations x chunks whose audio every station's
publish received / window seconds; the window spans exactly the reads of
the chunks counted (from the first one's start to the next one's)."""


def read(run):
    if run["loop"] != "serve_fused":
        return None
    return run["stations"] * run["chunks"] / run["window_s"]
