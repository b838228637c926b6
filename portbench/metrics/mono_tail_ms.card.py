"""``mono_tail_ms.card``: the device time of the mono groups of a mixed
step, the ``tail_mfm`` and ``tail_fm`` spans summed in each replay of the
compiled step's traced graph inside ``profiling.tracing()``; the median
of those sums."""

import statistics

SPANS = ("tail_mfm", "tail_fm")


def read(run):
    stages = run.get("graph_stages", {})
    times = [stages[name] for name in SPANS if stages.get(name)]
    if not times:
        return None
    return statistics.median(sum(each) for each in zip(*times))
