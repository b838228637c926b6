"""``between_ms.served``: per chunk of the window, its wall time less
the time inside the server's stages: the ingest pipe's host memcpy into
its pinned slot and the launch of its copy, and the loop's own Python."""


def read(run):
    return run.get("served", {}).get("between_ms")
