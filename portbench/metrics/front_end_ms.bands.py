"""``front_end_ms.bands``: the device time of the multi-band step's front
end, the ``band_fft`` and ``extract`` spans' event pairs summed in each
replay of the compiled step's traced graph inside
``profiling.tracing()``; the median of those sums."""

import statistics

SPANS = ("band_fft", "extract")


def read(run):
    stages = run.get("graph_stages", {})
    if not all(stages.get(name) for name in SPANS):
        return None
    return statistics.median(sum(each) for each in
                             zip(*(stages[name] for name in SPANS)))
