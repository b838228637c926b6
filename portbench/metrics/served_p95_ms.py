"""``served_p95_ms``: the 95th percentile, over every chunk of the
window, of the time from the start of a chunk's read to the hand-over of
its last station's audio to the publisher."""

import statistics


def read(run):
    lat = run.get("latencies_s") if run["loop"] == "serve_fused" else None
    if not lat:
        return None
    if len(lat) == 1:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
