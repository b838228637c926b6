"""``extract_roofline``: the extraction stage's share of its roofline,
the bound of ``portbench/roofline.py`` over the device time of
``step.stages["extract"]`` captured alone as a CUDA graph (CUDA events
around its replay, median of the traced run's repetitions)."""

from portbench import roofline


def read(run):
    ms = run.get("stage_ms", {}).get("extract")
    if ms is None:
        return None
    return 100.0 * roofline.extract_bound_ms(
        run["config"], run["device_name"]) / ms
