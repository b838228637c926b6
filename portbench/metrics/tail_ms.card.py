"""``tail_ms.card``: device time of ``step.stages["demod_tail"]`` (demod,
the WBFM tail, de-emphasis), captured alone as a CUDA graph and timed by
CUDA events around its replay; median of the traced run's repetitions."""


def read(run):
    return run.get("stage_ms", {}).get("demod_tail")
