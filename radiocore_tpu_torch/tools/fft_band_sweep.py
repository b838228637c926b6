"""K-BANDFFT on one NVIDIA GPU: its error and time at the 10 MS/s band
against cuFFT's, and the time of variants of its source.

Run from the root of a checkout: ``python3 -m
radiocore_tpu_torch.tools.fft_band_sweep``. It builds the kernel library
and prints what ``ptxas`` reports for K-BANDFFT's two kernels (registers,
spills); then, at 1 and 2 rows of 10^7 points, both signs: the kernels'
rel_l2 against cuFFT in complex128 beside cuFFT's own in complex64, and
whether the input is left as it was; the device time after an L2 flush
(CUDA events around each call, a 256 MB memset before it) of the
kernels and of cuFFT, beside the bytes bound; then the same time for
each of :data:`VARIANTS` at one row (``chip_smoke.py`` times each pass
apart, from the kernels' names in a profile).

Prints the card's name and power limit first; every time is that card's.
One JSON line at the end, also written to
``chiprun_out/fft_band_sweep.json``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

N = 10_000_000
BATCHES = (1, 2)
REPS = 20
SEED = 2929
HBM_BYTES_PER_S = 3.35e12


# Variants of csrc/fft_band.cu (text replacements), each built into a
# library of its own and timed at 1 x 10^7 beside the shipped source: they
# tell where the time goes, and most compute something else.
NO_LOADS = (
    ("p < 2 * d.L;", "p < 0;"),
    ("const int pieces = 8 * d.tiles;", "const int pieces = 0;"),
    )
VARIANTS = {
    # The row pass stores each row's points contiguously (the transpose of
    # the result): the cost of the strided store.
    "row store contiguous": (
        ("o.base = out + band * d.n + row;",
         "o.base = out + band * d.n + (long long)row * d.b;"),
        ("o.base[d.a * k] = v;", "o.base[k] = v;")),
    # The column pass without the outer twiddle.
    "column no outer twiddle": (
        ("=\n          cmul(v, tw);", "= v;"),),
    # Each tile loaded, nothing transformed or stored.
    "load only": (
        ("    band_chain<ROW, L, R0, R1, R2>(cur, first, stw, d, o, t, w, j0t,\n"
         "                                   issue);",
         "    issue(0, 1);"),),
    # Nothing loaded: the stages run on what shared memory holds.
    "compute only": NO_LOADS,
    # Nothing loaded and nothing stored: the stages alone.
    "stages only": NO_LOADS + (
        ("    if (o.valid) {\n      o.base[(k >> 5)",
         "    if (v.x == 1234.5f) {\n      o.base[(k >> 5)"),
        ("o.base[d.a * k] = v;", "if (v.x == 1234.5f) o.base[0] = v;")),
}


def build_variants(work: Path) -> dict:
    """Each of :data:`VARIANTS` built into ``work``: name → its
    ``rc_fft_band``."""
    import ctypes
    from radiocore_tpu_torch.kernels import build
    src = (build.CSRC_DIR / "fft_band.cu").read_text()
    nvcc = build.find_nvcc()
    cmds, libs = [], {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"fft_band_sweep: {old!r} is not in "
                                   f"csrc/fft_band.cu once")
            text = text.replace(old, new)
        cu = work / f"band_{i}.cu"
        cu.write_text(text)
        libs[name] = work / f"libband_{i}.so"
        cmds.append([nvcc, *build.COMPILE_FLAGS, "-I", str(build.CSRC_DIR),
                     "-shared", "-o", str(libs[name]), str(cu)])
    build._run_all(cmds)
    out = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).rc_fft_band
        fn.argtypes = build._SIGNATURES["rc_fft_band"]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def call(fn, x, scratch, y, a: int, b: int) -> None:
    """``rc_fft_band`` of a variant's library, as ``fft_band.launch``
    calls the shipped one (forward sign)."""
    import torch
    from radiocore_tpu_torch.kernels import build, fft_band
    err = fn(x.data_ptr(), scratch.data_ptr(), y.data_ptr(),
             x.numel() // (a * b), a, b, -1,
             fft_band.band_table(a, b, x.device).data_ptr(),
             fft_band.band_first(a, b, x.device).data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "a variant's rc_fft_band")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.stdout else "?"


def flushed_ms(fn, flush, reps: int = REPS) -> float:
    """Median device time of ``fn()``, each call after a memset of
    ``flush`` (larger than the L2) queued ahead of its start event."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def rel_l2(got, want) -> float:
    import torch
    d = got.to(want.dtype) - want
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(want))


def ptxas_lines(log: str):
    """The ``ptxas`` lines of the band kernels' entries."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = "band_pass_kernel" in line
        if keep and ("entry" in line or "registers" in line
                     or "spill" in line or "stack" in line):
            lines.append(line.strip())
    return lines


def write_sass(lib: Path, out: Path) -> None:
    """The SASS of the band kernels in ``lib`` (``cuobjdump``) into
    ``out``, where the toolkit has it."""
    from radiocore_tpu_torch.kernels import build
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    keep, lines = False, []
    for line in text.splitlines():
        if "Function :" in line:
            keep = "band_pass_kernel" in line
        if keep:
            lines.append(line)
    out.write_text("\n".join(lines) + "\n")


def main() -> int:
    import torch
    from radiocore_tpu_torch.kernels import build, fft_band
    if not torch.cuda.is_available():
        print("fft_band_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(card_line())
    res = build.build()
    build.library()
    print(f"[build] {res.seconds:.1f} s")
    for line in ptxas_lines(res.log):
        print(f"[build] {line}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    write_sass(res.path, out / "fft_band_sass.txt")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    a, b = fft_band.band_split(N)
    chains = (fft_band.CHAINS[a], fft_band.CHAINS[b])
    record = {"card": card_line(), "split": [a, b],
              "chains": [list(c) for c in chains]}
    print(f"[band] split {a} x {b}, chains {chains}")
    probe = torch.ones(1, N, dtype=torch.complex64, device=dev)
    got = fft_band.fft_band_rows(probe)
    torch.cuda.synchronize()
    print(f"[band] first call on a constant row: X[0] {complex(got[0, 0])}, "
          f"max |X[1:]| {float(got[0, 1:].abs().max()):.3e}", flush=True)
    del probe, got
    for batch in BATCHES:
        x = torch.complex(torch.randn(batch, N, generator=gen, device=dev),
                          torch.randn(batch, N, generator=gen, device=dev))
        keep = x.clone()
        ref = {-1: torch.fft.fft(x.to(torch.complex128)),
               1: torch.fft.ifft(x.to(torch.complex128), norm="forward")}
        for sign in (-1, 1):
            got = fft_band.fft_band_rows(x, sign)
            lib = fft_band.fft_band_plain(x, sign)
            torch.cuda.synchronize()
            err, lib_err = rel_l2(got, ref[sign]), rel_l2(lib, ref[sign])
            same = bool(torch.equal(x, keep))
            print(f"[band] {batch} x {N} sign {sign:+d}: rel_l2 {err:.3e} "
                  f"(cuFFT complex64 {lib_err:.3e}, ratio "
                  f"{err / lib_err:.2f}); input unchanged {same}")
            record[f"rel_l2_{batch}_{sign:+d}"] = err
            record[f"cufft_rel_l2_{batch}_{sign:+d}"] = lib_err
            record[f"input_unchanged_{batch}_{sign:+d}"] = same
            del got, lib
        del ref
        y = torch.empty_like(x)
        scratch = torch.empty(batch * fft_band.scratch_points(a, b),
                              dtype=x.dtype, device=dev)
        least = 16.0 * batch * N / HBM_BYTES_PER_S * 1e3
        times = {
            "kernel": flushed_ms(lambda: fft_band.launch(
                x, scratch, y, -1.0, a, b), flush),
            "cufft": flushed_ms(lambda: torch.fft.fft(x), flush),
        }
        print(f"[band] {batch} x {N} after an L2 flush: kernels "
              f"{times['kernel']:.4f} ms, cuFFT {times['cufft']:.4f} ms; "
              f"bytes bound {least:.4f} ms (kernels at "
              f"{100 * least / times['kernel']:.1f}%)")
        record[f"ms_{batch}"] = times
        record[f"least_ms_{batch}"] = least
        if batch == 1:
            build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            work = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
            try:
                for name, fn in build_variants(work).items():
                    ms = flushed_ms(lambda: call(fn, x, scratch, y, a, b),
                                    flush)
                    print(f"[band] variant {name}: {ms:.4f} ms after a "
                          f"flush")
                    record.setdefault("variants", {})[name] = ms
            finally:
                shutil.rmtree(work, ignore_errors=True)
        del x, keep, y, scratch
        torch.cuda.empty_cache()
    line = json.dumps(record)
    (out / "fft_band_sweep.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
