"""The port's overlapped ingest (``runtime/ingest.py``) against
``tests/test_ingest.py``: values, order, prefetch, the threaded shape and
the isolation of the producer's buffers, on the CPU, with the JAX
package's pipe fed the same chunks.

The reference's ``test_verify_staged_restages_on_failure`` has no
counterpart: re-staging through the blocking resilient path is a relay
workaround the port does not carry (a failed copy raises)."""

import numpy as np
import pytest
import torch

from radiocore_tpu.runtime import ingest as jax_ingest
from radiocore_tpu_torch.runtime.ingest import (IngestPipe, ThreadedIngest,
                                                stage_chunk, verify_staged)

torch.set_num_threads(2)

RNG = np.random.default_rng(5)


def _chunks(n, size):
    return [(RNG.standard_normal(size) + 1j * RNG.standard_normal(size))
            .astype(np.complex64) for _ in range(n)]


def test_stage_chunk_roundtrip():
    arr = _chunks(1, 4096)[0]
    dev, done = stage_chunk(arr, device="cpu")
    assert done is None
    assert dev.dtype == torch.complex64
    got = verify_staged(dev, done)
    assert got is dev
    np.testing.assert_array_equal(got.numpy(), arr)
    arr[:] = 0  # the staged chunk owns its data
    assert bool(torch.any(dev != 0))


def test_stage_chunk_non_c64_input():
    arr = (np.arange(64) + 1j * np.arange(64)).astype(np.complex128)
    dev, _ = stage_chunk(arr, device="cpu")
    np.testing.assert_array_equal(dev.numpy(), arr.astype(np.complex64))
    np.testing.assert_array_equal(
        dev.numpy(), np.asarray(jax_ingest.stage_chunk(arr)))


def test_pipe_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        IngestPipe(depth=2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        stage_chunk(np.zeros(4, np.complex64))


def test_pipe_rejects_depth_zero():
    with pytest.raises(ValueError):
        IngestPipe(depth=0, device="cpu")


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipe_preserves_order_and_values(depth):
    chunks = _chunks(7, 1024)
    out = list(IngestPipe(depth=depth, device="cpu").stream(chunks))
    want = [np.asarray(x) for x in
            jax_ingest.IngestPipe(depth=depth).stream(chunks)]
    assert len(out) == len(chunks) == len(want)
    for got, ref, host in zip(out, want, chunks):
        assert got.dtype == torch.complex64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), host)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipe_prefetches_ahead(depth):
    """When chunk k is yielded, chunks up to k + depth − 1 have been pulled
    from the source (their copies were issued), as in the JAX pipe."""
    staged = []

    def recorder(arrs):
        for i, a in enumerate(arrs):
            staged.append(i)
            yield a

    chunks = _chunks(5, 256)
    for k, _ in enumerate(IngestPipe(depth=depth, device="cpu").stream(
            recorder(chunks))):
        assert len(staged) == min(k + depth, len(chunks))


def test_threaded_ingest_roundtrip():
    chunks = _chunks(5, 512)
    ti = ThreadedIngest(depth=2, maxsize=8, device="cpu")  # 5 puts + close
    for c in chunks:
        ti.put(c)
    ti.close()
    out = [x.numpy() for x in ti]
    assert len(out) == 5
    for got, want in zip(out, chunks):
        np.testing.assert_array_equal(got, want)


def test_threaded_ingest_producer_reuses_buffer():
    """ThreadedIngest.put copies: a producer that mutates its buffer right
    after put() must not corrupt the enqueued data."""
    chunks = _chunks(4, 512)
    ti = ThreadedIngest(depth=2, maxsize=8, device="cpu")
    buf = np.empty(512, np.complex64)
    for c in chunks:
        buf[:] = c
        ti.put(buf)          # producer reuses ONE buffer for every chunk
        buf[:] = -1.0        # mutate before the consumer drains anything
    ti.close()
    out = [x.numpy() for x in ti]
    assert len(out) == len(chunks)
    for got, want in zip(out, chunks):
        np.testing.assert_array_equal(got, want)


def test_threaded_ingest_from_a_thread():
    """A producer thread feeds the consumer; every chunk arrives in
    order."""
    import threading

    chunks = _chunks(12, 256)
    ti = ThreadedIngest(depth=2, maxsize=2, device="cpu")

    def producer():
        for c in chunks:
            ti.put(c, timeout=10)
        ti.close()

    thread = threading.Thread(target=producer)
    thread.start()
    out = [x.numpy() for x in ti]
    thread.join(timeout=10)
    assert not thread.is_alive()
    for got, want in zip(out, chunks, strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_mutated_host_buffer_isolation(depth):
    """The pipe copies a chunk as it takes it, so the producer may
    overwrite its one buffer right away, whatever the depth (the JAX pipe
    needs depth + 1 buffers for that)."""
    buf = _chunks(1, 2048)[0]
    first = buf.copy()

    def gen():
        yield buf
        buf[:] = 0  # overwrite as soon as the pipe has taken the chunk
        yield buf

    out = [x.numpy() for x in IngestPipe(depth=depth,
                                         device="cpu").stream(gen())]
    np.testing.assert_array_equal(out[0], first)
    np.testing.assert_array_equal(out[1], np.zeros_like(first))


def test_pipe_feeds_a_step():
    """The pipe's chunks go straight into a model class: a tensor already
    on the device as complex64 is taken without a copy."""
    from radiocore_tpu_torch.models.decimate import Decimate

    chunks = _chunks(2, 4096)
    dec = Decimate(4096, 1024, device="cpu")
    for dev, host in zip(IngestPipe(depth=2, device="cpu").stream(chunks),
                         chunks):
        np.testing.assert_allclose(dec.run(dev).numpy(),
                                   dec.run(host).numpy(), rtol=0, atol=0)
