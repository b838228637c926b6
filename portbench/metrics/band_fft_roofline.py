"""``band_fft_roofline``: the band FFT stage's share of its roofline, the
bound of ``portbench/roofline.py`` over the device time of
``step.stages["band_fft"]`` captured alone as a CUDA graph (CUDA events
around its replay, median of the traced run's repetitions). A time below
one read and write of the band at peak is refused."""

from portbench import roofline


def read(run):
    ms = run.get("stage_ms", {}).get("band_fft")
    if ms is None:
        return None
    roofline.check_band_fft_floor(run["config"], ms, run["device_name"])
    return 100.0 * roofline.band_fft_bound_ms(
        run["config"], run["device_name"]) / ms
