"""``nco_roofline``: K-NCO's share of its floor, the larger of its bytes
at peak and its serial chain (``portbench/roofline_serial.py``) times
its launches a step over the window, over its device time a step in the
traced run's profiled stretch (every launch summed by kernel name)."""

from portbench import roofline_serial


def read(run):
    ms = run.get("nco_ms_a_step")
    launches = run.get("nco_launches_a_step")
    if not ms or not launches:
        return None
    floor = roofline_serial.nco_floor_ms(run["config"], run["device_name"])
    return 100.0 * floor * launches / ms
