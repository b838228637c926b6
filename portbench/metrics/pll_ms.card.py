"""``pll_ms.card``: the device time of the ``pll`` span (the pilot's
normalisation, K-NCO and the subcarrier) inside the compiled step's
graph, median over the replays of the stretch run inside
``profiling.tracing()``."""

import statistics


def read(run):
    times = run.get("graph_stages", {}).get("pll")
    if not times:
        return None
    return statistics.median(times)
