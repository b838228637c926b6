"""``gather_roofline``: K-GATHER's share of its bytes bound (every band's
kept bins read once and station IQ written once,
``portbench/roofline_bands.py``) times its launches a step over the
window, over its device time a step in the traced run's profiled
stretch (every kernel whose name holds ``gather_kernel``, summed)."""

from portbench import roofline_bands


def read(run):
    ms = run.get("gather_ms_a_step")
    launches = run.get("gather_launches_a_step")
    if not ms or not launches:
        return None
    return 100.0 * roofline_bands.gather_bound_ms(
        run["config"], run["device_name"]) * launches / ms
