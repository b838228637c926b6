"""Constants of the port's steps are copied to the device once, not on
every call: a host→device copy inside a CUDA graph's capture is refused
(or captures a pointer to a host buffer freed at once), so each of these
sites keeps a cached device constant (``ops/consts.device_array`` or a
``runtime/graphs.device_cache``). Each site runs twice with the same
constants; the second call must make no ``torch.from_numpy`` and no
``torch.tensor``, counted by monkeypatch. Its output is held to the JAX
function at the bound of the site's existing test."""

import numpy as np
import pytest
import torch
from scipy import signal as sig

import jax.numpy as jnp

torch.set_num_threads(2)

REL = 1e-5        # tests/test_torch_fir_ops.py, tests/test_torch_resample.py
PFB_ATOL = 2e-6   # tests/test_torch_pfb.py


class Uploads:
    """Counts calls of ``torch.from_numpy`` and ``torch.tensor``."""

    def __init__(self, monkeypatch):
        self.count = 0
        for name in ("from_numpy", "tensor"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, self._counted(real))

    def _counted(self, real):
        def call(*args, **kwargs):
            self.count += 1
            return real(*args, **kwargs)
        return call


def _twice(monkeypatch, fn):
    """``fn()`` twice; returns the second result and the uploads the
    second call made."""
    fn()
    uploads = Uploads(monkeypatch)
    out = fn()
    return out, uploads.count


def _close(got: torch.Tensor, want, rel=REL) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_fir_causal_plain_taps_are_copied_once(monkeypatch):
    from radiocore_tpu.ops import fir as jf
    from radiocore_tpu_torch.kernels.fir import fir_causal_plain
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 10_000)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal((2, 50)).astype(np.float32))
    taps = sig.firwin(51, 0.2)
    got, uploads = _twice(monkeypatch,
                          lambda: fir_causal_plain(x, taps, hist))
    assert uploads == 0
    _close(got, jf.fir_causal(jnp.asarray(x.numpy()), taps,
                              history=jnp.asarray(hist.numpy()),
                              impl="conv"))


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_overlap_save_tap_spectrum_is_copied_once(monkeypatch, complex_):
    from radiocore_tpu.ops import fir as jf
    from radiocore_tpu_torch.ops.fir import fir_overlap_save
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 20_000))
    if complex_:
        x = x + 1j * rng.standard_normal((2, 20_000))
    x = x.astype(np.complex64 if complex_ else np.float32)
    taps = sig.firwin(63, 0.3)
    xt = torch.from_numpy(x)
    got, uploads = _twice(monkeypatch,
                          lambda: fir_overlap_save(xt, taps, block=4096))
    assert uploads == 0
    _close(got, jf.fir_overlap_save(jnp.asarray(x), taps, block=4096))


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_resample_fft_window_is_copied_once(monkeypatch, complex_):
    from radiocore_tpu.ops import resample as jr
    from radiocore_tpu_torch.ops.resample import resample_fft
    rng = np.random.default_rng(13)
    n, num = 1000, 321
    x = rng.standard_normal(n)
    if complex_:
        x = x + 1j * rng.standard_normal(n)
    x = x.astype(np.complex64 if complex_ else np.float32)
    win = np.fft.fftshift(sig.get_window("hamm", n))
    xt = torch.from_numpy(x)
    got, uploads = _twice(monkeypatch,
                          lambda: resample_fft(xt, num, window=win))
    assert uploads == 0
    _close(got, jr.resample_fft(jnp.asarray(x), num, window=win))


def test_pfb_branch_kernels_are_copied_once(monkeypatch):
    from radiocore_tpu.ops.pfb import pfb_channelize as jax_pfb
    from radiocore_tpu_torch.ops.pfb import pfb_channelize, pfb_taps
    m, p = 16, 8
    rng = np.random.default_rng(14)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    taps = pfb_taps(m, p)
    xt = torch.from_numpy(x)
    hist = torch.zeros((p - 1) * m, dtype=torch.complex64)
    (got, got_h), uploads = _twice(
        monkeypatch, lambda: pfb_channelize(xt, taps, m, history=hist))
    assert uploads == 0
    want, want_h = jax_pfb(jnp.asarray(x), taps, m,
                           history=jnp.asarray(hist.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PFB_ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=PFB_ATOL)


def test_device_array_copies_once_per_contents_and_dtype(monkeypatch):
    from radiocore_tpu_torch.ops.consts import device_array
    a = np.linspace(0.0, 1.0, 7)
    first = device_array(a, "cpu", torch.float32)
    uploads = Uploads(monkeypatch)
    assert device_array(a.copy(), "cpu", torch.float32) is first
    assert uploads.count == 0
    other = device_array(a, "cpu", torch.float64)
    assert uploads.count == 1 and other.dtype == torch.float64
    assert torch.equal(other.float(), first)
