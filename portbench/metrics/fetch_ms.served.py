"""``fetch_ms.served``: mean over the window's chunks of the ``fetch``
stage of ``serve_fused`` (the wait for the step and the audio's copy to
the host), host clock."""


def read(run):
    return run.get("served", {}).get("fetch_ms")
