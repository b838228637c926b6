"""Fused multi-station pipeline; counterpart of
``radiocore_tpu/parallel/pipeline.py`` (``make_multi_station_step``: on
one device, ``mode='exact'``, and ``mode='fast'`` with the hoisted
station rfft and the fused extract+demod paths of
``RADIOCORE_TPU_EXTRACT_DEMOD``; over a rank mesh with ``mesh=``).

    band IQ (n_band,) ──K-FFT or K-MIXED──► spectrum
    exact:   ──K-EXTRACT──► (C, m) station IQ ──exact WBFM step over the
             station batch (K-FIR pilot bandpass and de-emphasis)──► audio
    fast:
      off:   ──K-EXTRACT──► (C, m) station IQ ──demod──► quad
      fused: ──K-XDEMOD──► quad
             quad ──K-FFT rfft──► composite spectra
      spec:  ──K-XDEMOD-SPEC──► composite spectra (needed bins only)
    composite spectra ──fast_spec tail (K-FIR de-emphasis)──► audio
        (C, audio_chunk, 2)

A mix of demodulators (``kinds``: WBFM, MFM and FM stations, as the
upstream server serves them) extracts every station in one launch, its
rows grouped by kind, and runs each kind's batched step over its group:

    spectrum ──K-GATHER (rows WBFM, MFM, FM)──► (C, m) station IQ
             ──WBFM step──► (C_w, audio_chunk, 2)
             ──MFM step──► (C_m, audio_chunk)
             ──FM step──► (C_f, audio_chunk)

A batch of bands of one rate (``bands``: several SDRs side by side, each
band with its own station plan) runs every stage once over the batch:

    bands (B, n_band) ──one FFT over the batch──► spectra
             ──K-GATHER (each row its band and start)──► (R, m) station IQ
             ──the one-band step's demod and tail over all R rows──► audio
                 (R, audio_chunk, 2), band after band

On a CUDA device every kernel stage runs the hand-written kernel; on
the CPU the same code runs their plain PyTorch versions. ``routes``
(:class:`~radiocore_tpu_torch.runtime.routes.Routes`) can send the band
FFT, the extraction's inverse, the station rfft, the tail's transforms
and its FIR elsewhere; the defaults give the diagram above.

With a mesh, each rank takes its contiguous block of the band and
returns the audio and state of its block of the stations, both dealt
over every rank in row-major mesh order (``parallel/mesh``'s ``shard``
and ``station_sharding``; :func:`gather_stations` joins the audio):

    distributed (a uniform critical plan, ``channelize_sharded``):
             band block ──six-step FFT, roll, extraction──► (C/D, m) IQ
    otherwise: band block ──all-gather──► band ──FFT──► spectrum
             ──extraction of this rank's stations──► station IQ
    station IQ ──the demod and tail of one device──► audio block
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.extract_demod import (
    extract_demod_ok, extract_demod_rows, extract_demod_spec_ok,
    extract_demod_spec_rows)
from radiocore_tpu_torch.kernels.fft_rows import LaunchCounter
from radiocore_tpu_torch.models.fm import make_fm_step
from radiocore_tpu_torch.models.mfm import make_mfm_step, mfm_init_state
from radiocore_tpu_torch.models.wbfm import make_wbfm_step, wbfm_init_state
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.channelize import (make_band_extractor,
                                                make_extractor,
                                                uniform_extraction_start)
from radiocore_tpu_torch.ops.demod import quadrature_demod
from radiocore_tpu_torch.parallel.channelize_sharded import make_extract_body
from radiocore_tpu_torch.parallel.collectives import all_gather
from radiocore_tpu_torch.parallel.mesh import (FLAT, RadioMesh,
                                               station_sharding)
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.profiling import span
from radiocore_tpu_torch.runtime.routes import Routes, resolve

State = Dict[str, torch.Tensor]

KINDS = ("wbfm", "mfm", "fm")   # a mixed step's groups, in row order
# Stations demodulated by each group of a mixed step, advanced by the
# group's rows a call; a compiled step adds a capture's count at every
# replay, as it adds a kernel's launches (``runtime/graphs``).
demodulated = {kind: LaunchCounter() for kind in KINDS}
# Bands stepped: a step advances it by its bands a call (1 for one band),
# and a compiled step adds the capture's count at every replay.
bands = LaunchCounter()


def _stepped(n_bands: int) -> None:
    bands.count += n_bands


def make_multi_station_step(
        n_band: int,
        offsets_hz: Optional[Sequence[int]],
        station_chunk: int,
        audio_chunk: int,
        deemphasis: float = 75e-6,
        mode: str = "exact",
        extract_demod: str = "off",
        *,
        pll: str = "analytic",
        kinds: Optional[Sequence[str]] = None,
        bands: Optional[Sequence[Sequence[int]]] = None,
        device: Optional[torch.device | str] = None,
        mesh: Optional[RadioMesh] = None,
        routes: Optional[Routes] = None,
) -> Tuple[Callable[[torch.Tensor, State], Tuple[torch.Tensor, State]],
           State]:
    """Build ``step(band_iq, state) -> (audio, state)`` plus the initial
    state on ``device`` (the first CUDA device when None, as the model
    classes resolve it).

    ``n_band`` is the band chunk (== band sample rate, one-second
    convention), ``offsets_hz`` the station offsets from the band centre
    (== bins), ``station_chunk`` the per-station IQ chunk and
    ``audio_chunk`` the audio samples per station per chunk.

    ``mode`` is the WBFM step's: ``"exact"`` runs the reference pipeline
    over the extracted station batch, ``"fast"`` the envelope-domain one.

    ``extract_demod`` is the JAX package's ``RADIOCORE_TPU_EXTRACT_DEMOD``
    as an argument, for ``mode="fast"`` (the reference takes the fused
    routes in no other mode; here anything but ``"off"`` with
    ``mode="exact"`` raises): ``"off"`` extracts the station IQ and
    demodulates it;
    ``"fused"`` turns the band spectrum into the quad in one kernel
    (K-XDEMOD) and takes its rfft; ``"spec"`` turns it into the composite
    spectra the tail reads (K-XDEMOD-SPEC). A plan the fused kernels do
    not support raises ``ValueError`` (the JAX package falls back to
    ``"off"`` there).

    ``pll`` is the exact tail's pilot tracker (``models/wbfm``):
    ``"analytic"`` (stateless, the default) or ``"nco"``, the feedback
    loop (K-NCO on a card), whose state the step carries from chunk to
    chunk as ``state["pll"]`` (a ``PLLState`` per station). ``"nco"``
    needs ``mode="exact"`` and ``extract_demod="off"`` and takes no mesh;
    anything else raises ``ValueError`` (the WBFM step checks the mode
    and the name).

    ``kinds`` gives each station's demodulator, in the order of
    ``offsets_hz``: ``"wbfm"`` (stereo, the step's ``mode`` and ``pll``),
    ``"mfm"`` (mono broadcast FM: de-emphasis, DC removal, clip) or
    ``"fm"`` (quadrature demod and decimation). None, or every station
    ``"wbfm"``, builds the all-WBFM step described here and below. A mix
    builds the same three stages with one extraction whose rows come out
    grouped by kind, WBFM then MFM then FM (the plan's shifts permuted;
    K-GATHER writes any plan in its output order, so the grouping costs
    no copy), and a ``demod_tail`` that runs each present kind's batched
    step over its contiguous rows, inside a span ``tail_wbfm``,
    ``tail_mfm`` or ``tail_fm`` (``demodulated[kind]`` counts its rows).
    The audio is a dict by kind, ``wbfm`` ``(C_w, audio_chunk, 2)``,
    ``mfm`` ``(C_m, audio_chunk)`` and ``fm`` ``(C_f, audio_chunk)``: a
    mono station is computed mono, with no padded second channel, so the
    kinds cannot share one tensor. The state is ``{"wbfm": <the WBFM
    state>, "mfm": {"deemph": ...}}`` (FM carries none), each key only
    where its kind is present; ``step.rows[kind]`` gives the station
    indices of each group in ``offsets_hz`` order. A mix raises
    ``ValueError`` with ``extract_demod`` other than ``"off"`` (the fused
    kernels make a WBFM quad for every row) or with a mesh; so does a
    ``kinds`` of the wrong length or with an unknown kind.

    ``bands`` serves a batch of B bands of one rate (``n_band`` each):
    pass ``offsets_hz=None`` and band b's station offsets from its own
    centre as ``bands[b]``, each band its own plan and station count. The
    step then takes ``(B, n_band)`` complex64, runs one band FFT over the
    batch, one extraction over every band's stations
    (:func:`~radiocore_tpu_torch.ops.channelize.make_band_extractor`: one
    K-GATHER launch on the card, each row reading its own band, where no
    band's plan is one that K-EXTRACT takes) and the
    demod and tail over all R stations, and returns audio ``(R,
    audio_chunk, 2)`` and a state of R rows, band after band and in each
    band in the order of its offsets; ``step.band_rows[b]`` is band b's
    range of rows. Each row is what the one-band step of its band gives.
    ``pll`` works per row as in one band. ``bands`` with ``offsets_hz``,
    with ``kinds``, with ``extract_demod`` other than ``"off"`` or with a
    mesh raises ``ValueError``; so does an empty band, a station whose
    channel leaves its band, and a call with a batch of another shape.
    ``bands`` (the module's counter) advances by B a call, and by 1 a
    call of a one-band step.

    ``step.stages`` holds the three stages that ``step`` chains, for
    per-stage timing: ``band_fft``, ``extract`` and ``demod_tail`` for
    ``"off"``; ``band_fft``, ``extract_demod`` and ``tail`` otherwise.
    The step wraps each in a ``runtime.profiling`` span of its key: with
    tracing on, a host span in an eager step; in a captured one, a pair
    of timing events in the graph inside ``profiling.tracing()``, and
    nothing under a profile alone.

    On one CUDA device the step is compiled (``runtime/graphs``): captured
    once per input signature as a CUDA graph, replayed for each chunk, and
    returning fresh tensors; ``step.eager`` is its eager body and
    ``step.stages`` stay eager.

    With ``mesh`` (a :class:`~radiocore_tpu_torch.parallel.mesh.RadioMesh`;
    ``extract_demod="off"``, as the reference's mesh path takes no fused
    route) each rank builds and runs its own step on ``mesh.device``:
    ``step(band_block, state)`` takes this rank's contiguous block of the
    band (``parallel.mesh.shard(band, mesh, FLAT)``) and returns the audio
    and state of its block of the stations
    (``parallel.mesh.station_sharding``). When
    ``channelize_sharded.make_extract_body`` takes the plan, the front
    end is distributed (no rank holds the band or its spectrum);
    otherwise the band is gathered and each rank extracts its own
    stations. Either way each rank demodulates its stations as one
    device does. ``step.stages`` is ``front_end`` and ``demod_tail``.
    The mesh step stays eager: its gloo collectives run on the host.

    ``routes`` (None: the defaults) goes to the band FFT, the extractor
    (``extract_ifft``), the tail (``env_fft``, ``fir_impl``, its
    transforms) and the mesh path. ``routes.station_rfft`` picks the
    station rfft of the ``fast`` step in the ``off`` and ``fused`` modes
    (:func:`station_rfft_route`), as the reference's
    ``RADIOCORE_TPU_STATION_RFFT`` does in ``off``; the reference's
    ``fused`` path ignores that variable, and ``"native"`` gives its
    route (``Routes`` says why the default differs).
    """
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {mode!r}; 'exact' or 'fast'")
    if extract_demod not in ("off", "fused", "spec"):
        raise ValueError(f"extract_demod={extract_demod!r}: expected "
                         f"'off', 'fused' or 'spec'")
    if mode == "exact" and extract_demod != "off":
        raise ValueError(f"extract_demod={extract_demod!r} needs "
                         f"mode='fast': the exact step works on the "
                         f"station IQ")
    if pll == "nco" and mesh is not None:
        raise ValueError("pll='nco' with a mesh: the mesh step carries no "
                         "loop state")
    if bands is not None:
        if offsets_hz is not None:
            raise ValueError("offsets_hz and bands: give one band's "
                             "offsets_hz, or bands with offsets_hz=None")
        for what, given in (("kinds", kinds is not None),
                            (f"extract_demod={extract_demod!r}",
                             extract_demod != "off"),
                            ("a mesh", mesh is not None)):
            if given:
                raise ValueError(f"bands with {what}: a batch of bands "
                                 f"decodes WBFM on one device, through "
                                 f"extract_demod='off'")
        return _bands_step(n_band, bands, station_chunk, audio_chunk,
                           deemphasis, mode, pll, device, routes)
    if offsets_hz is None:
        raise ValueError("no stations: give offsets_hz, or bands")
    rows = _kind_rows(kinds, len(offsets_hz))
    if rows is not None:
        if extract_demod != "off":
            raise ValueError(f"kinds with extract_demod={extract_demod!r}: "
                             f"the fused kernels make a WBFM quad for "
                             f"every row")
        if mesh is not None:
            raise ValueError("kinds with a mesh: the mesh step demodulates "
                             "WBFM only")
    if mesh is not None:
        if extract_demod != "off":
            raise ValueError(f"extract_demod={extract_demod!r} with a mesh: "
                             f"the mesh path takes no fused route")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device={device!r} differs from the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    routes = resolve(routes)
    n_stations = len(offsets_hz)
    n_band = int(n_band)
    sc = int(station_chunk)
    # Roll = band_center − station_center = −offset (tuner convention).
    shifts = tuple(int(-o) for o in offsets_hz)
    spec = extract_demod == "spec"
    if extract_demod != "off":
        a0 = uniform_extraction_start(n_band, shifts, sc)
        ok = extract_demod_spec_ok if spec else extract_demod_ok
        if a0 is None or sc % 2 or not ok(n_band, sc, n_stations):
            raise ValueError(
                f"extract_demod={extract_demod!r}: unsupported plan "
                f"n_band={n_band}, station_chunk={sc}, "
                f"{n_stations} stations (needs a uniform plan that "
                f"{ok.__name__} accepts)")
    tail = make_wbfm_step(
        sc, audio_chunk, deemphasis,
        mode="exact" if mode == "exact" else "fast_spec", pll=pll,
        routes=routes)

    def band_fft(band_iq: torch.Tensor) -> torch.Tensor:
        return _fft.fft(band_iq, routes)

    def station_rfft(quad: torch.Tensor) -> torch.Tensor:
        return _station_rfft(quad, sc, routes)

    demod_tail = _demod_tail(tail, mode, sc, routes)

    if mesh is not None:
        return _mesh_step(mesh, n_band, shifts, sc, audio_chunk, deemphasis,
                          demod_tail, routes)

    state0 = None
    if rows is not None:
        # One extraction, its plan permuted so that the rows come out
        # grouped by kind.
        shifts = tuple(shifts[i] for r in rows.values() for i in r)
        demod_tail, state0 = _mixed_tail(rows, demod_tail, sc, audio_chunk,
                                         deemphasis, pll, device, routes)
    if extract_demod == "off":
        extract = make_extractor(n_band, shifts, sc, routes)

        def extract_stations(spectrum: torch.Tensor) -> torch.Tensor:
            return extract(spectrum).to(torch.complex64)

        stages = {"band_fft": band_fft, "extract": extract_stations,
                  "demod_tail": demod_tail}
    else:
        nb = int(tail.needed_bins)

        if spec:
            def xdemod(spectrum: torch.Tensor) -> torch.Tensor:
                return extract_demod_spec_rows(spectrum, a0, n_stations, sc,
                                               keep_bins=nb)

            def xtail(q_spec: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
                return tail(q_spec[:, :nb], state)
        else:
            def xdemod(spectrum: torch.Tensor) -> torch.Tensor:
                return extract_demod_rows(spectrum, a0, n_stations, sc)

            def xtail(quad: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
                return tail(station_rfft(quad), state)

        stages = {"band_fft": band_fft, "extract_demod": xdemod,
                  "tail": xtail}

    (n1, first), (n2, middle), (n3, last) = stages.items()

    def step(band_iq: torch.Tensor, state: State
             ) -> Tuple[torch.Tensor, State]:
        _stepped(1)
        with span(n1):
            x = first(band_iq)
        with span(n2):
            x = middle(x)
        with span(n3):
            return last(x, state)

    step.stages = stages
    if state0 is None:
        state0 = wbfm_init_state(audio_chunk, deemphasis,
                                 batch_shape=(n_stations,), pll=pll,
                                 device=device)
    compiled = compile_step(step, device)
    if rows is not None:
        compiled.rows = rows
    return compiled, state0


def _station_rfft(quad: torch.Tensor, sc: int, routes: Routes
                  ) -> torch.Tensor:
    """The ``fast`` step's station rfft (:func:`station_rfft_route`)."""
    if station_rfft_route(sc, quad.is_cuda, routes) == "rows":
        return fft_rows.rfft_pow2(quad.contiguous())
    return _fft.rfft(quad, routes)


def _demod_tail(tail: Callable[[torch.Tensor, State],
                               Tuple[torch.Tensor, State]],
                mode: str, sc: int, routes: Routes):
    """The ``demod_tail`` stage over station IQ: the exact WBFM step takes
    the IQ itself (batch-generic: the stations ride along); the fast one
    takes the composite spectra of the IQ's quadrature demod."""
    if mode == "exact":
        return tail

    def demod_tail(st_iq: torch.Tensor, state: State
                   ) -> Tuple[torch.Tensor, State]:
        return tail(_station_rfft(quadrature_demod(st_iq), sc, routes),
                    state)

    return demod_tail


def _bands_step(n_band: int, bands_hz: Sequence[Sequence[int]],
                station_chunk: int, audio_chunk: int, deemphasis: float,
                mode: str, pll: str, device: Optional[torch.device | str],
                routes: Optional[Routes]):
    """:func:`make_multi_station_step` over a batch of bands, each with
    its own offsets (``bands``)."""
    n_band, sc = int(n_band), int(station_chunk)
    plans = [tuple(int(o) for o in offs) for offs in bands_hz]
    if not plans or not all(plans):
        raise ValueError(f"bands: every band needs a station, got "
                         f"{[len(p) for p in plans]} stations")
    for b, plan in enumerate(plans):
        for o in plan:
            if abs(o) + sc // 2 > n_band // 2:
                raise ValueError(
                    f"band {b}: the station at {o} Hz leaves its band (a "
                    f"{sc}-S/s channel in a {n_band}-S/s band reaches "
                    f"{n_band // 2 - sc // 2} Hz from the centre)")
    device = resolve_device(device)
    routes = resolve(routes)
    tail = make_wbfm_step(
        sc, audio_chunk, deemphasis,
        mode="exact" if mode == "exact" else "fast_spec", pll=pll,
        routes=routes)
    extract = make_band_extractor(
        n_band, [[-o for o in plan] for plan in plans], sc, routes)
    shape = (len(plans), n_band)

    def band_fft(band_iq: torch.Tensor) -> torch.Tensor:
        if tuple(band_iq.shape) != shape:
            raise ValueError(f"the step takes {len(plans)} bands of "
                             f"{n_band} samples, {shape}, got "
                             f"{tuple(band_iq.shape)}")
        return _fft.fft(band_iq, routes)

    def extract_stations(spectra: torch.Tensor) -> torch.Tensor:
        return extract(spectra).to(torch.complex64)

    demod_tail = _demod_tail(tail, mode, sc, routes)

    def step(band_iq: torch.Tensor, state: State
             ) -> Tuple[torch.Tensor, State]:
        _stepped(len(plans))
        with span("band_fft"):
            x = band_fft(band_iq)
        with span("extract"):
            x = extract_stations(x)
        with span("demod_tail"):
            return demod_tail(x, state)

    step.stages = {"band_fft": band_fft, "extract": extract_stations,
                   "demod_tail": demod_tail}
    n_rows = sum(len(plan) for plan in plans)
    state0 = wbfm_init_state(audio_chunk, deemphasis,
                             batch_shape=(n_rows,), pll=pll, device=device)
    compiled = compile_step(step, device)
    a, band_rows = 0, []
    for plan in plans:
        band_rows.append(range(a, a + len(plan)))
        a += len(plan)
    compiled.band_rows = tuple(band_rows)
    return compiled, state0


def _kind_rows(kinds: Optional[Sequence[str]], n_stations: int
               ) -> Optional[Dict[str, Tuple[int, ...]]]:
    """Each present kind's station indices, in row order, for a mix; None
    for no ``kinds`` or every station WBFM."""
    if kinds is None:
        return None
    kinds = tuple(kinds)
    if len(kinds) != n_stations:
        raise ValueError(f"{len(kinds)} kinds for {n_stations} stations")
    unknown = sorted(set(kinds) - set(KINDS))
    if unknown:
        raise ValueError(f"unknown kinds {unknown}; expected {KINDS}")
    if set(kinds) == {"wbfm"}:
        return None
    rows = {kind: tuple(i for i, k in enumerate(kinds) if k == kind)
            for kind in KINDS}
    return {kind: r for kind, r in rows.items() if r}


def _mixed_tail(rows: Dict[str, Tuple[int, ...]],
                wbfm_tail: Callable[[torch.Tensor, State],
                                    Tuple[torch.Tensor, State]],
                sc: int, audio_chunk: int, deemphasis: float, pll: str,
                device: torch.device, routes: Routes):
    """The ``demod_tail`` stage and initial state of a mix of kinds
    (:func:`make_multi_station_step`'s ``kinds``) over station IQ whose
    rows are grouped as ``rows`` orders them; ``wbfm_tail`` is the WBFM
    group's demod and tail, as the all-WBFM step runs them."""
    tails, state0 = {}, {}
    if "wbfm" in rows:
        tails["wbfm"] = wbfm_tail
        state0["wbfm"] = wbfm_init_state(
            audio_chunk, deemphasis, batch_shape=(len(rows["wbfm"]),),
            pll=pll, device=device)
    if "mfm" in rows:
        tails["mfm"] = make_mfm_step(sc, audio_chunk, deemphasis, routes)
        state0["mfm"] = mfm_init_state(
            audio_chunk, deemphasis, batch_shape=(len(rows["mfm"]),),
            device=device)
    if "fm" in rows:
        fm = make_fm_step(sc, audio_chunk, routes)
        tails["fm"] = lambda iq, state: (fm(iq), None)
    groups, a = {}, 0
    for kind, r in rows.items():
        groups[kind] = (a, a + len(r))
        a += len(r)

    def demod_tail(st_iq: torch.Tensor, state: Dict[str, State]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, State]]:
        audio, new = {}, {}
        for kind, (a, b) in groups.items():
            with span("tail_" + kind):
                audio[kind], group_state = tails[kind](st_iq[a:b],
                                                       state.get(kind))
            if group_state is not None:
                new[kind] = group_state
            demodulated[kind].count += b - a
        return audio, new

    return demod_tail, state0


def station_rfft_route(station_chunk: int, is_cuda: bool,
                       routes: Optional[Routes] = None) -> str:
    """Where the ``fast`` step's station rfft goes, in the ``off`` and
    ``fused`` modes: ``"rows"`` (K-FFT's ``rfft_pow2``, its plain version
    on the CPU) or ``"torch"``. ``routes.station_rfft`` ``"auto"`` is
    ``"pallas"`` on the card and ``"native"`` on the CPU; ``"pallas"``
    takes ``rfft_pow2`` where half the station chunk is a K-FFT row;
    ``"native"`` is ``ops.fft.rfft``'s route (``"torch"`` below
    ``fft_kernel_min``), the reference's ``fused`` route."""
    r = resolve(routes)
    sc = int(station_chunk)
    impl = r.station_rfft
    if impl == "auto":
        impl = "pallas" if is_cuda else "native"
    if (impl == "pallas" and (sc & (sc - 1)) == 0
            and fft_rows.MIN_ROW <= sc // 2 <= fft_rows.MAX_ROW):
        return "rows"
    return _fft.route_name(sc, torch.float32, is_cuda, r, op="rfft")


def _mesh_step(mesh: RadioMesh, n_band: int, shifts: Tuple[int, ...],
               sc: int, audio_chunk: int, deemphasis: float,
               demod_tail: Callable[[torch.Tensor, State],
                                    Tuple[torch.Tensor, State]],
               routes: Routes):
    """This rank's step over the flat (row-major) axis of ``mesh``."""
    axis = mesh.axis(FLAT)
    d = axis.size
    if n_band % d:
        raise ValueError(f"n_band={n_band} does not split over {d} ranks")
    if len(shifts) < d:
        raise ValueError(f"{len(shifts)} stations for {d} ranks: every "
                         f"rank needs one")
    mine = station_sharding(mesh, len(shifts))
    body = make_extract_body(n_band, shifts, sc, d, axis, routes)
    if body is not None:
        def front_end(block: torch.Tensor) -> torch.Tensor:
            return body(block).to(torch.complex64)
    else:
        extract = make_extractor(n_band, shifts[mine], sc, routes)

        def front_end(block: torch.Tensor) -> torch.Tensor:
            band = all_gather(block, axis).reshape(-1)
            return extract(_fft.fft(band, routes)).to(torch.complex64)

    def step(band_block: torch.Tensor, state: State
             ) -> Tuple[torch.Tensor, State]:
        with span("front_end"):
            x = front_end(band_block)
        with span("demod_tail"):
            return demod_tail(x, state)

    step.stages = {"front_end": front_end, "demod_tail": demod_tail}
    step.distributed = body is not None
    state0 = wbfm_init_state(audio_chunk, deemphasis,
                             batch_shape=(mine.stop - mine.start,),
                             device=mesh.device)
    return step, state0


def gather_stations(x: torch.Tensor, mesh: RadioMesh) -> torch.Tensor:
    """Every rank's block of a station axis (the leading one, as the
    audio of a mesh step), joined in station order, on every rank."""
    axis = mesh.axis(FLAT)
    sizes = all_gather(torch.tensor([x.shape[0]], device=x.device),
                       axis).reshape(-1).tolist()
    padded = x.new_zeros((max(sizes),) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    parts = all_gather(padded, axis)
    return torch.cat([parts[i, :k] for i, k in enumerate(sizes)])
