"""``bands_fft_roofline``: the band FFT stage over a batch of bands, its
share of ``bands`` times one band's roofline
(``portbench/roofline_bands.py``), over the device time of
``step.stages["band_fft"]`` fed the whole batch and captured alone as a
CUDA graph (CUDA events around its replay, median of the traced run's
repetitions). A time below one read and write of every band at peak is
refused; a configuration of one band reads nothing."""

from portbench import roofline_bands


def read(run):
    ms = run.get("stage_ms", {}).get("band_fft")
    if ms is None or "bands" not in run["config"]:
        return None
    roofline_bands.check_bands_fft_floor(run["config"], ms,
                                         run["device_name"])
    return 100.0 * roofline_bands.bands_fft_bound_ms(
        run["config"], run["device_name"]) / ms
