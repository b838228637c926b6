"""``enqueue_ms.card``: the host's time for one ``step(band, state)``
call (copy-in, graph replay, clone-out) from an idle queue, without a
synchronize inside the call; mean of the traced run's repetitions."""


def read(run):
    return run.get("enqueue_ms")
