"""``source_ms.served``: mean over the window's chunks of the
``source`` stage of ``serve_fused`` (the file read through
``IQFileSource``), host clock."""


def read(run):
    return run.get("served", {}).get("source_ms")
