"""``setup_s``: process start to window start (building, warming and,
in a cell's first run in a checkout, compiling), on the host's clock."""


def read(run):
    return run["setup_s"]
