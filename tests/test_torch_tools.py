"""The port's host tools against ``tests/test_tools.py`` and
``tests/test_native_ring.py``: Buffer, RingBuffer (both backends),
Carrousel, Chopper and the native ring built from the port's own C++
copy. Where a tool returns data, the same operations go through the JAX
package's tool and must give the same values."""

import threading

import numpy as np
import pytest
import torch

import radiocore_tpu as jrc
from radiocore_tpu_torch import Buffer, Carrousel, Chopper, RingBuffer
from radiocore_tpu_torch.native import build as native_build
from radiocore_tpu_torch.native import native_available

torch.set_num_threads(2)

BACKENDS = ["python", "native"]


def _need_native(backend):
    if backend == "native" and not native_available():
        pytest.skip("no C++ toolchain")


def test_buffer_consume_persists():
    buf = Buffer(16, dtype="float32")
    with buf.consume() as arr:
        assert isinstance(arr, np.ndarray)
        arr[:4] = 1.5
    with buf.consume() as arr:
        assert np.all(arr[:4] == 1.5)
        assert np.all(arr[4:] == 0)
    assert not buf.is_device and not buf.is_cuda


def test_buffer_device_consume_persists():
    """A device buffer yields its tensor itself: writes persist with no
    staging copy (reference: tests/test_buffer.py:8-30)."""
    buf = Buffer(16, dtype="float32", device="cpu")
    assert buf.is_device and not buf.is_cuda
    assert buf.dtype == torch.float32
    with buf.consume() as arr:
        assert arr is buf.data
        arr[:4] = 1.5
    with buf.consume() as arr:
        assert bool(torch.all(arr[:4] == 1.5))
        assert bool(torch.all(arr[4:] == 0))
    assert np.all(buf.data.numpy()[:4] == 1.5)


@pytest.mark.parametrize("kwargs", [dict(device=True), dict(cuda=True)])
def test_buffer_card_without_card_raises(kwargs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Buffer(8, **kwargs)


def test_buffer_matches_jax_surface():
    mine, theirs = Buffer(8, dtype="complex64"), jrc.Buffer(8, "complex64")
    assert (mine.size, len(mine), mine.dtype) == (theirs.size, len(theirs),
                                                  theirs.dtype)


def test_buffer_lock():
    buf = Buffer(8, lock=True)
    assert not buf.is_locked
    with buf.consume():
        assert buf.is_locked
    assert not buf.is_locked
    with pytest.raises(ValueError):
        Buffer(8).is_locked


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_fifo_and_accounting(backend):
    _need_native(backend)
    ring = RingBuffer(8, dtype="float32", print_overflow=False,
                      backend=backend)
    assert ring.backend == backend and ring.capacity == 8
    ring.put(np.arange(4, dtype=np.float32))
    assert ring.occupancy == 4 and ring.vacancy == 4
    out = np.zeros(4, np.float32)
    assert ring.get(out) is True
    np.testing.assert_array_equal(out, np.arange(4))
    assert ring.occupancy == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_wraparound(backend):
    _need_native(backend)
    ring = RingBuffer(8, dtype="float32", print_overflow=False,
                      backend=backend)
    ring.put(np.arange(6, dtype=np.float32))
    out = np.zeros(6, np.float32)
    assert ring.get(out) is True
    ring.put(np.arange(10, 16, dtype=np.float32))  # wraps around the end
    out = np.zeros(6, np.float32)
    assert ring.get(out) is True
    np.testing.assert_array_equal(out, np.arange(10, 16))
    assert ring.occupancy == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_overflow_resets(backend):
    """Overflow hard-resets the ring before the write (reference
    semantics: occupancy 8 → 4 after an overflowing put)."""
    _need_native(backend)
    ring = RingBuffer(8, dtype="float32", print_overflow=False,
                      backend=backend)
    ring.put(np.zeros(8, np.float32))
    assert ring.occupancy == 8
    ring.put(np.ones(4, np.float32))
    assert ring.occupancy == 4 and ring.overflows == 1
    out = np.zeros(4, np.float32)
    ring.get(out)
    np.testing.assert_array_equal(out, np.ones(4))


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_get_timeout_returns_none(backend):
    _need_native(backend)
    ring = RingBuffer(8, dtype="float32", backend=backend)
    out = np.zeros(4, np.float32)
    assert ring.get(out, timeout=0.05) is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_rejects_oversize(backend):
    _need_native(backend)
    ring = RingBuffer(4, dtype="float32", backend=backend)
    with pytest.raises(ValueError):
        ring.put(np.zeros(5, np.float32))
    with pytest.raises(ValueError):
        ring.get(np.zeros(5, np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_no_overflow_raises(backend):
    _need_native(backend)
    ring = RingBuffer(4, dtype="float32", allow_overflow=False,
                      backend=backend)
    ring.put(np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        ring.put(np.zeros(1, np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_sequence_matches_jax(backend):
    """One seeded sequence of puts and gets (overflows included) through
    the port's ring and the JAX package's: the same samples come out and
    the same counters read."""
    _need_native(backend)
    rng = np.random.default_rng(11)
    rings = [RingBuffer(64, dtype="complex64", print_overflow=False,
                        backend=backend),
             jrc.RingBuffer(64, dtype="complex64", print_overflow=False,
                            backend=backend)]
    for _ in range(200):
        n = int(rng.integers(1, 40))
        if rng.random() < 0.55:
            data = (rng.standard_normal(n)
                    + 1j * rng.standard_normal(n)).astype(np.complex64)
            for r in rings:
                r.put(data)
        else:
            outs = [np.zeros(n, np.complex64) for _ in rings]
            got = [r.get(o, timeout=0.0) for r, o in zip(rings, outs)]
            assert got[0] == got[1]
            np.testing.assert_array_equal(outs[0], outs[1])
        assert (rings[0].occupancy, rings[0].overflows) == (
            rings[1].occupancy, rings[1].overflows)


def test_native_backend_selected():
    _need_native("native")
    assert RingBuffer(16, dtype="float32").backend == "native"
    assert RingBuffer(16, dtype="float32",
                      backend="python").backend == "python"


def test_native_built_from_the_ports_copy():
    """The library comes from the port's own .cpp, into the port's
    ``_build/``, never from the JAX package's files or cache."""
    _need_native("native")
    src = native_build._SRC
    assert src.parent.name == "native"
    assert src.parent.parent.name == "radiocore_tpu_torch"
    path = native_build._lib_path(src, "libradiocore_ring.so")
    assert path.exists()
    assert path.parent.parent == native_build.BUILD_DIR
    assert native_build.BUILD_DIR.parent.name == "_build"
    assert native_build.BUILD_DIR.parent.parent.name == "radiocore_tpu_torch"


def test_native_complex64():
    _need_native("native")
    ring = RingBuffer(16, dtype="complex64", backend="native")
    data = (np.arange(8) + 1j * np.arange(8)).astype(np.complex64)
    ring.put(data)
    out = np.zeros(8, np.complex64)
    assert ring.get(out) is True
    np.testing.assert_array_equal(out, data)


def test_native_bytes_put():
    _need_native("native")
    ring = native_build.load_native_ring(16)
    assert ring.put_bytes(b"abcd") == 1
    assert ring.occupancy_bytes == 4
    out = np.zeros(4, np.uint8)
    assert ring.get_bytes(out) == 1
    assert bytes(out) == b"abcd"
    assert ring.put_bytes(np.zeros(17, np.uint8)) == -1


@pytest.mark.parametrize("backend", BACKENDS)
def test_ringbuffer_spsc_stress(backend):
    """Producer/consumer threads: every sample arrives in order."""
    _need_native(backend)
    n_chunks, chunk = 200, 512
    ring = RingBuffer(chunk * 8, dtype="float32", backend=backend,
                      print_overflow=False)
    src = np.arange(n_chunks * chunk, dtype=np.float32)
    received = np.empty_like(src)

    def producer():
        for i in range(n_chunks):
            while ring.vacancy < chunk:
                pass  # back-pressure: no overflow allowed in the test
            ring.put(src[i * chunk:(i + 1) * chunk])

    thread = threading.Thread(target=producer)
    thread.start()
    buf = np.zeros(chunk, np.float32)
    for i in range(n_chunks):
        assert ring.get(buf, timeout=5.0) is True
        received[i * chunk:(i + 1) * chunk] = buf
    thread.join(timeout=5)
    assert not thread.is_alive()
    np.testing.assert_array_equal(received, src)
    assert ring.overflows == 0


def test_carrousel_cycles_slots():
    car = Carrousel([np.zeros(2) for _ in range(3)], print_overflow=False)
    assert car.capacity == 3 and car.is_empty
    with car.enqueue() as slot:
        slot[:] = 1
    with car.enqueue() as slot:
        slot[:] = 2
    assert car.occupancy == 2 and car.is_healthy
    with car.dequeue() as slot:
        assert slot[0] == 1
    with car.dequeue() as slot:
        assert slot[0] == 2
    assert car.is_empty
    with pytest.raises(ValueError):
        with car.dequeue():
            pass


def test_carrousel_overflow_advances_head():
    """After overflowing a full carrousel, the oldest item is dropped:
    first dequeue yields item 2, not item 1 (reference test_carrousel.py)."""
    car = Carrousel([np.zeros(1) for _ in range(3)], print_overflow=False)
    for v in (1, 2, 3):
        with car.enqueue() as slot:
            slot[:] = v
    assert car.is_full
    with car.enqueue() as slot:  # overflow: drops item 1
        slot[:] = 4
    assert car.overflow == 1
    with car.dequeue() as slot:
        assert slot[0] == 2


@pytest.mark.parametrize("device", [False, "cpu"])
def test_carrousel_unwraps_buffer_items(device):
    items = [Buffer(4, dtype="float32", device=device) for _ in range(2)]
    car = Carrousel(items)
    with car.enqueue() as raw:
        assert isinstance(raw, torch.Tensor if device else np.ndarray)
        raw[:] = 7
    with car.dequeue() as raw:
        assert all(float(v) == 7 for v in raw)


def test_carrousel_of_tensors():
    car = Carrousel([torch.zeros(3) for _ in range(2)], print_overflow=False)
    with car.enqueue() as slot:
        slot.fill_(5)
    with car.dequeue() as slot:
        assert bool(torch.all(slot == 5))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_chopper(as_tensor):
    chop = Chopper(12, 4)
    arr = torch.arange(12) if as_tensor else np.arange(12)
    chunks = list(chop.chop(arr))
    assert len(chunks) == 3 and chop.n_chunks == 3
    np.testing.assert_array_equal(np.asarray(chunks[1]), [4, 5, 6, 7])
    np.testing.assert_array_equal(np.asarray(chop.chop_batch(arr)),
                                  np.arange(12).reshape(3, 4))
    with pytest.raises(ValueError):
        Chopper(10, 4)
    assert Chopper.get_to_da_choppa() == jrc.Chopper.get_to_da_choppa()
