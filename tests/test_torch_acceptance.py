"""The port's acceptance drive (``radiocore_tpu_torch.tools.acceptance``)
on the CPU, as tests/test_acceptance_smoke.py runs the JAX package's:
acceptance configs 1-4 and fidelity configs 1 and 2 pass (fidelity 3, the
10 MS/s band through the float64 oracle, is the slowest on the CPU and
runs on the card in ``chip_smoke.py``); config 2's audio equals the JAX
package's WBFM step on the same IQ; a check below its bar fails the
drive; without a card the drive does not fall back to the CPU."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiocore_tpu_torch.tools import acceptance

torch.set_num_threads(2)

ATOL = 4e-5      # audio, as tests/test_pipeline_pallas.py


def _lines(out: str):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("configs,fidelity", [("2,3", "2"), ("1,4", "1")])
def test_acceptance_passes_on_the_cpu(capsys, configs, fidelity):
    rc = acceptance.main(["--device", "cpu", "--configs", configs,
                          "--fidelity", fidelity])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = _lines(out)
    assert lines[0] == {"device": "cpu", "kind": "cpu"}
    assert lines[-1] == {"acceptance": "PASS"}
    checks = {rec["check"]: rec for rec in lines[1:-1]}
    assert all(rec["ok"] for rec in checks.values()), checks
    names = [f"fidelity{k}" for k in fidelity.split(",")] + [
        f"config{k}" for k in configs.split(",")]
    for name in names:
        assert any(c.startswith(name + "_") for c in checks), name
    # No launch counts on the CPU: the kernels' plain versions ran.
    assert not any("launches" in rec for rec in checks.values())


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_config2_audio_matches_jax(mode):
    from radiocore_tpu.models.wbfm import make_wbfm_step, wbfm_init_state
    from radiocore_tpu_torch.ops import synth
    iq = synth.stereo_fm_iq(250_000, 250_000.0, 440.0, 1000.0,
                            device="cpu").numpy()
    got = acceptance.wbfm_audio(torch.from_numpy(iq), mode).numpy()
    step = make_wbfm_step(250_000, acceptance.AUDIO, mode=mode)
    want, _ = step(jnp.asarray(iq), wbfm_init_state(acceptance.AUDIO))
    assert got.shape == (acceptance.AUDIO, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_a_check_below_its_bar_fails_the_drive(capsys, monkeypatch):
    monkeypatch.setattr(acceptance, "FIR_REL_MAX", 1e-12)
    rc = acceptance.main(["--device", "cpu", "--configs", "4",
                          "--fidelity", ""])
    lines = _lines(capsys.readouterr().out)
    assert rc == 1
    assert lines[-1] == {"acceptance": "FAIL"}
    assert [rec["ok"] for rec in lines[1:-1]] == [False]


def test_a_kernel_that_never_launched_fails_its_check():
    assert acceptance._launch_extra(None) == ({}, True)
    assert acceptance._launch_extra({"K-FIR": 3, "K-EXTRACT": 16}) == (
        {"launches": {"K-FIR": 3, "K-EXTRACT": 16}}, True)
    assert not acceptance._launch_extra({"K-FIR": 3, "K-EXTRACT": 0})[1]


def test_unknown_configs_are_refused():
    with pytest.raises(SystemExit, match="unknown config"):
        acceptance.main(["--device", "cpu", "--configs", "5"])


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        acceptance.main(["--configs", "", "--fidelity", ""])
