"""Benchmark: EM-iteration HMM-cell throughput vs the reference C++ binary.

Prints ONE JSON line on stdout (logs go to stderr):
  {"metric": "em_cells_per_s", "value": ..., "unit": "cells/s",
   "vs_baseline": ..., "device": {...}, ...}

"cells" follows BASELINE.json's north-star definition: sites x individuals
x states (K=2) processed by the fwd-bwd E-step once per EM iteration.
"device" names what the numbers were taken on: JAX's platform, device
kind and count, and the card's name and power limit from nvidia-smi.
The bench needs a GPU; with none it fails.

Legs:
 - SMALL (default 100k x 32, host-synthesised GLs): matched-config
   comparison against the reference binary (fgvieira/ngsF-HMM) built from
   /root/reference and timed on this host's CPU with
   n_threads = min(n_cpu, n_ind); `vs_baseline` is the per-EM-iteration
   wallclock ratio T_ref / T_ours from this leg. Reference per-iter time
   comes from its own verbose-1 timers.
 - BIG (default 1M x 100, GLs synthesised on the device): the headline
   `value`/`ms_per_em_iter`, plus the est_maf stage alone.
 - WIDE (250k x 1000) and STREAM (10M x 100, 50M x 100, 10M x 1000
   through models/streaming.py with chunks synthesised on the device).

Every EM leg runs the Triton GL-fused tier (numerics="pallas"). Timing:
host clock around work that ends in jax.block_until_ready; EM legs
report the median of their warm iterations and every iteration.

Env knobs: NGSF_BENCH_SITES, NGSF_BENCH_IND, NGSF_BENCH_ITERS,
NGSF_BENCH_BIG=0 (skip the 1M x 100 leg), NGSF_BENCH_BIG_SITES,
NGSF_BENCH_BIG_IND, NGSF_BENCH_STREAM=0 (skip the 10M stream leg),
NGSF_BENCH_STREAM_SITES/IND/CHUNK, NGSF_BENCH_SKIP_REF=1,
NGSF_BENCH_REF_TIMEOUT (seconds, default 360: watchdog on the reference
leg -- on expiry the bench logs the failure to stderr and falls back to
the recorded dev-host baseline).
"""

import gzip
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
REF_SRC = pathlib.Path("/root/reference")
REF_BUILD = REPO / "tests" / ".refbin"

S = int(os.environ.get("NGSF_BENCH_SITES", 100_000))
N = int(os.environ.get("NGSF_BENCH_IND", 32))
ITERS = int(os.environ.get("NGSF_BENCH_ITERS", 5))
BIG = os.environ.get("NGSF_BENCH_BIG", "1") == "1"
BIG_S = int(os.environ.get("NGSF_BENCH_BIG_SITES", 1_000_000))
BIG_N = int(os.environ.get("NGSF_BENCH_BIG_IND", 100))
REF_ITERS = 3  # extra iterations used to isolate ref per-iter time

# Reference em-iteration cells/s measured on the dev host (AMD EPYC-class,
# 32 threads, config 100k x 32) -- fallback only.
REF_FALLBACK_CELLS_PER_S = 2.0e6

def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_inputs(rng):
    """Synthetic low-coverage GLs + positions (log-space, normalised)."""
    depth = rng.poisson(2.0, size=(S, N))
    truth = rng.integers(0, 3, size=(S, N))
    err = 0.01
    p_der = np.array([err, 0.5, 1 - err])[truth]
    der = rng.binomial(depth, p_der)
    k = der[..., None].astype(np.float64)
    n = depth[..., None].astype(np.float64)
    p = np.array([err, 0.5, 1 - err])[None, None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ll = k * np.log(p) + (n - k) * np.log1p(-p)
    ll = np.where(n == 0, 0.0, ll)
    # normalise in log space
    m = ll.max(-1, keepdims=True)
    lse = m + np.log(np.exp(ll - m).sum(-1, keepdims=True))
    gl = ll - lse  # [S, N, 3] normalised log GLs
    pos = np.cumsum(rng.integers(100, 200_000, size=S))
    return gl, pos


def write_ref_inputs(d, gl, pos):
    glf = d / "bench.glf"
    # reference binary mode: raw doubles, site-major [S][N][3]
    gl.astype(np.float64).tofile(glf)
    posf = d / "bench.pos.gz"
    with gzip.open(posf, "wt") as fh:
        for p in pos:
            fh.write(f"chr1\t{int(p)}\n")
    return glf, posf


def build_reference():
    exe = REF_BUILD / "ngsF-HMM"
    if exe.exists():
        return exe
    if not REF_SRC.exists():
        return None
    REF_BUILD.mkdir(parents=True, exist_ok=True)
    shim = REPO / "tests" / "gsl_shim"
    cpp = [
        "shared/gen_func.cpp", "shared/read_data.cpp", "shared/HMM.cpp",
        "shared/bfgs.cpp", "parse_args.cpp", "EM.cpp", "ngsF-HMM.cpp",
        "shared/threadpool.c",
    ]
    try:
        subprocess.run(
            ["g++", "-O3", "-w", f"-I{shim}", f"-I{REF_SRC}/shared"]
            + [str(REF_SRC / f) for f in cpp]
            + ["-lz", "-lpthread", "-o", str(exe)],
            check=True, capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log(f"[bench] cannot build reference binary: {e}")
        return None
    return exe


def time_reference(exe, d, glf, posf):
    """One reference run; per-iteration time parsed from its own
    verbose-1 timers (EM.cpp:89-95 prints "time: N (s)" per iteration) --
    avoids a second full run, which can exceed time budgets on loaded
    hosts. Exactly REF_ITERS iterations via min/max iters + a huge
    epsilon (min==max is rejected, parse_args.cpp:221)."""
    import re

    nthreads = min(os.cpu_count() or 1, N)
    args = (
        f"--geno {glf.name} --loglkl --pos {posf.name} --n_ind {N} "
        f"--n_sites {S} --freq 0.2 --indF 0.2,0.05 --n_threads {nthreads} "
        f"--seed 7 --verbose 1 --min_iters {REF_ITERS} "
        f"--max_iters {REF_ITERS + 1} --min_epsilon 100 --out ref1"
    )
    r = subprocess.run(
        [str(exe)] + args.split(), cwd=d, capture_output=True, text=True,
        timeout=int(os.environ.get("NGSF_BENCH_REF_TIMEOUT", 360)),
    )
    if r.returncode != 0:
        raise RuntimeError(r.stdout + r.stderr)
    times = [int(m) for m in re.findall(r"time: (\d+) \(s\)", r.stdout)]
    if not times:
        raise RuntimeError("no per-iteration timers in reference output")
    per_iter = max(sum(times) / len(times), 1.0)
    log(f"[bench] reference: per-iter times {times}s "
        f"-> {per_iter:.1f}s/iter ({nthreads} threads)")
    return per_iter


def _time_em_loop(step, state0, reps):
    """Two warm-up iterations, then `reps` timed ones, each ended by
    block_until_ready. Returns (median seconds, per-iteration seconds)."""
    import jax

    state = step(step(state0))
    jax.block_until_ready(state)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(step(state))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def _make_step(gl, dist):
    """Triton-tier EM step threading both cross-iteration caches, as
    run_em's loop does: the gl slab layout (prep_slabs) and the
    warm-started M-step's L-BFGS memory (opt_memory). Returns (step,
    holder); holder["opt_iters"] is the last iteration's outer L-BFGS
    count (a device scalar)."""
    from ngsf_hmm.models.em import em_iteration

    holder = {"slabs": None, "opt": None, "opt_iters": None}

    def step(st):
        st2, stats, slabs, opt = em_iteration(
            gl, dist, st, numerics="pallas",
            prep_slabs=holder["slabs"], return_prep=True,
            opt_memory=holder["opt"], return_opt=True,
            defer_emissions=True,  # as run_em's loop: e_prob is
            #                        write-only in-loop
        )
        holder["slabs"] = slabs
        holder["opt"] = opt
        holder["opt_iters"] = stats.opt_iters
        return st2

    return step, holder


def time_ours_small(gl, pos):
    import jax
    import jax.numpy as jnp

    from ngsf_hmm.models.em import init_state

    dev = jax.devices()[0]
    log(f"[bench] our engine on {dev.platform}:{dev.device_kind}")
    dtype = jnp.float32
    dist = np.empty(S, np.float64)
    dist[0] = pos[0] / 1e6
    dist[1:] = np.diff(pos) / 1e6

    gl_d = jax.device_put(jnp.asarray(gl, dtype), dev)
    dist_d = jax.device_put(jnp.asarray(dist, dtype), dev)
    state = init_state(
        gl_d,
        jnp.full((S,), 0.2, dtype),
        jnp.full((N,), 0.2, dtype),
        jnp.full((N,), 0.05, dtype),
    )
    step, holder = _make_step(gl_d, dist_d)
    per_iter, times = _time_em_loop(step, state, max(ITERS, 24))
    opt_iters = int(np.asarray(holder["opt_iters"]))
    log(f"[bench] ours (small {S}x{N}): median {per_iter * 1e3:.3f} "
        f"ms/EM-iter over {len(times)} iters (warm L-BFGS outer iters: "
        f"{opt_iters})")
    return per_iter, opt_iters


def time_ours_big(Sb=None, Nb=None, label="big", lean=False):
    """In-memory legs on GLs synthesised ON DEVICE (1M x 100 by default).

    The WIDE leg calls this with Nb=1000 and lean=True: the state is
    built with placeholder e_prob/p_ibd -- the Triton loop with deferred
    emissions never reads them, and init_state's full [S, N, 2] e_prob
    is a multi-GB transient at 250k x 1000."""
    import jax
    import jax.numpy as jnp

    from ngsf_hmm.models.em import EMState, init_state
    from ngsf_hmm.models.hmm_pallas import (
        freq_compact, posteriors_fused, prepare_gl_inputs,
    )
    from ngsf_hmm.ops.maf import est_maf
    from ngsf_hmm.tools.simulate import synth_device

    Sb = BIG_S if Sb is None else Sb
    Nb = BIG_N if Nb is None else Nb
    dt = jnp.float32

    t0 = time.perf_counter()
    gl, dist = synth_device(Sb, Nb, 20260817)
    if lean:
        state = EMState(
            freq=jnp.full((Sb,), 0.2, dt),
            indF=jnp.full((Nb,), 0.2, dt),
            alpha=jnp.full((Nb,), 0.05, dt),
            e_prob=jnp.zeros((1, 1, 2), dt),
            p_ibd=jnp.zeros((1, 1), dt),
            ind_lkl=jnp.zeros((Nb,), dt),
        )
    else:
        state = init_state(
            gl, jnp.full((Sb,), 0.2, dt), jnp.full((Nb,), 0.2, dt),
            jnp.full((Nb,), 0.05, dt),
        )
    jax.block_until_ready(state)
    log(f"[bench] {label} leg ({Sb}x{Nb}): on-device synth+init "
        f"{time.perf_counter() - t0:.1f}s")

    step, holder = _make_step(gl, dist)
    per_iter, times = _time_em_loop(step, state, 8)
    opt_iters = int(np.asarray(holder["opt_iters"]))
    log(f"[bench] ours ({label} {Sb}x{Nb}): "
        + " ".join(f"{t * 1e3:.2f}" for t in times)
        + f" ms/EM-iter -> median {per_iter * 1e3:.2f} (warm L-BFGS "
        f"outer iters: {opt_iters})")

    # est_maf alone (the XLA freq M-step, macro-stepped as in the loop)
    # on a real posterior: its trip counts are data-dependent
    prep2 = prepare_gl_inputs(jnp.exp(gl), dist)
    p_ibd, _, _ = posteriors_fused(
        state.indF, state.alpha, prep2, freq_compact(state.freq, prep2))
    maf_jit = jax.jit(lambda g, p: est_maf(jnp.exp(g), p, linear=True,
                                           macro=True))
    jax.block_until_ready(maf_jit(gl, p_ibd))
    t_maf = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(maf_jit(gl, p_ibd))
        t_maf.append(time.perf_counter() - t0)
    t_maf = float(np.median(t_maf))
    log(f"[bench] est_maf alone ({label}, macro): {t_maf * 1e3:.2f} ms")
    return per_iter, times, t_maf, opt_iters


def time_stream(Ss, Ns, cs, reps, prefix="stream"):
    """BASELINE-ladder rungs above 1M: REAL streamed EM iterations
    through models/streaming.StreamingEM -- chunked GL-fused pallas
    chain passes (emissions computed in-kernel from gl slabs; zero
    per-pass prep when the gl-slab cache fits HBM), boundary-carry
    assembly on host, device-resident freq, warm host L-BFGS. GL chunks
    are synthesised ON DEVICE per fetch (deterministic per chunk
    index), flagged as "<prefix>_synth": "on_device" in the JSON, so the
    host-to-device copy of real GLs is not in these numbers. Everything
    else (per-chunk transfers, host 2x2 chain algebra, the full M-step
    stream) is the production code path; the file-backed variant of the
    same path (--stream_file) is exercised byte-for-byte by
    tests/test_glsource.py + test_streaming.py.

    reps timed iterations run AFTER a discarded warmup iteration, so
    steady-state cache behaviour (run-lifetime gl slabs, per-epoch freq
    compacts) is what is measured; every iteration is reported and the
    MEDIAN is the summary.
    """
    import jax
    import jax.numpy as jnp

    from ngsf_hmm.models.em import EMOptions
    from ngsf_hmm.models.streaming import StreamingEM

    dt = jnp.float32

    @jax.jit
    def synth_chunk(key):
        # CHEAP deterministic GLs (Dirichlet(1,1,1) per site x ind): the
        # chunk is re-generated on every pass, standing in for what a
        # real host source delivers by DMA -- the generator must cost
        # (much) less than the chunk kernels or it becomes the
        # measurement. est_maf's macro schedule runs fixed trip counts,
        # so GL realism does not change the timed work.
        u = jax.random.uniform(key, (cs, Ns, 3), dt, 1e-6, 1.0)
        e = -jnp.log(u)
        return jnp.log(e / jnp.sum(e, axis=-1, keepdims=True))

    class _Shape:
        shape = (Ss, Ns, 3)

        def __getitem__(self, _):  # pragma: no cover - must not be hit
            raise RuntimeError("bench stream source is device-synth only")

    rng = np.random.default_rng(5)
    dist = rng.integers(100, 200_000, size=Ss).astype(np.float64) / 1e6

    class _DeviceSynthStream(StreamingEM):
        def _chunk(self, c):
            lo = c * self.cs
            hi = min(lo + self.cs, self.S)
            gl_c = synth_chunk(jax.random.PRNGKey(c))  # device, log GLs
            d_c = self.dist[lo:hi].astype(np.float32)
            if hi - lo < self.cs:
                d_c = np.pad(d_c, (0, self.cs - (hi - lo)))
            return gl_c, lo, hi, d_c

    se = _DeviceSynthStream(_Shape(), dist, chunk_sites=cs)
    opts = EMOptions(numerics="pallas", min_iters=1, max_iters=2,
                     min_epsilon=1e-9)

    freq = np.full(Ss, 0.2)
    F = np.full(Ns, 0.2)
    alpha = np.full(Ns, 0.05)

    t0 = time.perf_counter()
    freq_d = se._freq_pad_dev(freq)
    out = se._stream_iteration(freq_d, F, alpha, opts)  # warm/compile
    log(f"[bench] {prefix} leg ({Ss}x{Ns}, {se.C} chunks, gl-slab cache "
        f"{'on' if se._cache_e else 'off'}): warmup+compile "
        f"{time.perf_counter() - t0:.1f}s")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = se._stream_iteration(out[0], out[1], out[2], opts)
        times.append(time.perf_counter() - t0)
    per_iter = float(np.median(times))
    log(f"[bench] ours ({prefix} {Ss}x{Ns}): "
        + " ".join(f"{t * 1e3:.0f}" for t in times)
        + f" ms/EM-iter -> median {per_iter * 1e3:.0f} ms")
    return {
        f"{prefix}_config": f"{Ss}x{Ns}",
        f"{prefix}_chunks": se.C,
        f"ms_per_em_iter_{prefix}": round(per_iter * 1e3, 1),
        f"{prefix}_iter_ms": [round(t * 1e3, 1) for t in times],
        f"{prefix}_cells_per_s": round(Ss * Ns * 2 / per_iter, 1),
        f"{prefix}_glslab_cache": bool(se._cache_e),
        f"{prefix}_pin_k": int(getattr(se, "_pin_k", 0)),
        f"{prefix}_slab_bf16": bool(se._slab_dt == jnp.bfloat16),
        f"{prefix}_synth": "on_device",
    }


def time_reader_mbps():
    """Host-side MB/s of the native slab readers (native/ngsf_io.cpp) --
    the I/O layer that feeds real --stream_file runs (the host side
    only). Binary = the stream-file hot path (fseek + bulk
    doubles + normalise); text = the chunked-zlib Beagle scanner. Files
    are written once, one warm pass primes the page cache, then a timed
    pass reads the whole file in stream-sized site slabs -- so this is
    the PARSE/COPY throughput of the native layer (disk speed is
    hardware-specific and the page cache serves steady-state streams
    anyway)."""
    from ngsf_hmm.io import native, readers

    if not native.available():
        log("[bench] native IO core unavailable; reader leg skipped")
        return {}
    out = {}
    rng = np.random.default_rng(11)
    with tempfile.TemporaryDirectory() as td:
        d = pathlib.Path(td)
        # ---- binary doubles, site-major [S][N][3] (the --stream_file
        # format, read_data.cpp:83-99 layout)
        Nr, Sr, slab = 100, 300_000, 50_000
        raw = rng.random((Sr, Nr, 3)) + 1e-3
        glb = np.log(raw / raw.sum(-1, keepdims=True))
        fb = d / "r.glf"
        glb.tofile(fb)
        nbytes = fb.stat().st_size

        def _pass():
            for lo in range(0, Sr, slab):
                readers.read_geno_slab(
                    str(fb), Nr, Sr, (lo, min(slab, Sr - lo)), (0, Nr),
                    binary=True, probs=False, log_scale=True,
                )

        _pass()  # warm the page cache
        t0 = time.perf_counter()
        _pass()
        dt = time.perf_counter() - t0
        out["reader_mbps"] = round(nbytes / dt / 1e6, 1)
        log(f"[bench] native binary slab reader: {nbytes / 1e6:.0f} MB in "
            f"{dt:.2f}s -> {out['reader_mbps']} MB/s")

        # ---- gzip text (Beagle-style numeric rows through the
        # chunked-zlib line scanner + from_chars)
        St = 40_000
        glt = np.exp(glb[:St])
        ft = d / "r.glf.gz"
        with gzip.open(ft, "wb", compresslevel=1) as fh:
            for s in range(St):
                fh.write(
                    ("\t".join(f"{v:.6f}" for v in glt[s].ravel()) + "\n")
                    .encode()
                )
        tbytes = ft.stat().st_size

        def _tpass():
            for lo in range(0, St, slab // 4):
                readers.read_geno_slab(
                    str(ft), Nr, St, (lo, min(slab // 4, St - lo)), (0, Nr),
                    binary=False, probs=True, log_scale=False,
                )

        _tpass()
        t0 = time.perf_counter()
        _tpass()
        dt = time.perf_counter() - t0
        # report the UNCOMPRESSED parse rate alongside the gz byte rate:
        # the parse cost scales with text, not gz, bytes
        txt_bytes = St * Nr * 3 * 9  # ~9 B per "0.123456\t" token
        out["reader_mbps_text_gz"] = round(tbytes / dt / 1e6, 1)
        out["reader_mbps_text"] = round(txt_bytes / dt / 1e6, 1)
        log(f"[bench] native gzip-text reader: {tbytes / 1e6:.0f} MB gz "
            f"({txt_bytes / 1e6:.0f} MB text) in {dt:.2f}s -> "
            f"{out['reader_mbps_text_gz']} MB/s gz, "
            f"{out['reader_mbps_text']} MB/s text")
    return out


def device_info():
    """What the numbers were taken on; fails unless JAX sees a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX's platform is {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in smi.split(",", 1))
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "name": name, "power_limit": limit}


def main():
    sys.path.insert(0, str(REPO))
    from ngsf_hmm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    rng = np.random.default_rng(20260816)
    gl, pos = make_inputs(rng)

    reader_fields = {}
    if os.environ.get("NGSF_BENCH_READER", "1") == "1":
        try:
            reader_fields = time_reader_mbps()
        except Exception as e:  # noqa: BLE001
            log(f"[bench] reader leg failed: {e}")

    t_small, opt_iters_small = time_ours_small(gl, pos)
    small_cps = S * N * 2 / t_small

    vs = None
    if os.environ.get("NGSF_BENCH_SKIP_REF") != "1":
        exe = build_reference()
        if exe is not None:
            try:
                with tempfile.TemporaryDirectory() as td:
                    d = pathlib.Path(td)
                    glf, posf = write_ref_inputs(d, gl, pos)
                    t_ref = time_reference(exe, d, glf, posf)
                    vs = t_ref / t_small
            except Exception as e:  # noqa: BLE001
                log(f"[bench] reference run failed: {e}")
    fallback = vs is None
    if fallback:
        vs = small_cps / REF_FALLBACK_CELLS_PER_S
        log("[bench] WARNING: reference leg did not run; vs_baseline uses "
            f"the canned fallback {REF_FALLBACK_CELLS_PER_S:.3g} cells/s "
            "measured once on the dev host -- treat it as indicative only")

    out = {
        "metric": "em_cells_per_s",
        "unit": "cells/s",
        "vs_baseline": round(vs, 2),
        "device": device,
        "small_config": f"{S}x{N}",
        "ms_per_em_iter_small": round(t_small * 1e3, 2),
        "opt_iters_small": opt_iters_small,
        **reader_fields,
    }
    if fallback:
        out["vs_baseline_is_fallback"] = True

    if BIG:
        t_big, big_times, t_maf, opt_iters = time_ours_big()
        out.update({
            "value": round(BIG_S * BIG_N * 2 / t_big, 1),
            "config": f"{BIG_S}x{BIG_N}",
            "ms_per_em_iter": round(t_big * 1e3, 3),
            "ms_per_em_iter_all": [round(t * 1e3, 3) for t in big_times],
            "ms_est_maf": round(t_maf * 1e3, 3),
            "opt_iters": opt_iters,
        })
        if os.environ.get("NGSF_BENCH_WIDE", "1") == "1":
            # WIDE leg: the BASELINE ladder's N axis
            try:
                w_S = int(os.environ.get("NGSF_BENCH_WIDE_SITES",
                                         250_000))
                w_N = int(os.environ.get("NGSF_BENCH_WIDE_IND", 1000))
                t_w, w_times, t_wmaf, w_opt = time_ours_big(
                    Sb=w_S, Nb=w_N, label="wide", lean=True)
                w_cps = w_S * w_N * 2 / t_w
                out.update({
                    "wide_config": f"{w_S}x{w_N}",
                    "ms_per_em_iter_wide": round(t_w * 1e3, 2),
                    "ms_per_em_iter_wide_all": [
                        round(t * 1e3, 3) for t in w_times],
                    "ms_est_maf_wide": round(t_wmaf * 1e3, 2),
                    "wide_opt_iters": w_opt,
                    "wide_cells_per_s": round(w_cps, 1),
                    # per-cell time ratio vs the N=100 big leg
                    "wide_per_cell_vs_big": round(
                        (t_w / (w_S * w_N)) / (t_big / (BIG_S * BIG_N)),
                        3),
                })
            except Exception as e:  # noqa: BLE001
                log(f"[bench] wide leg failed: {e}")
                out["wide_error"] = str(e)[:200]
        if os.environ.get("NGSF_BENCH_STREAM", "1") == "1":
            try:
                out.update(time_stream(
                    int(os.environ.get("NGSF_BENCH_STREAM_SITES",
                                       10_000_000)),
                    int(os.environ.get("NGSF_BENCH_STREAM_IND", 100)),
                    int(os.environ.get("NGSF_BENCH_STREAM_CHUNK",
                                       1_000_000)),
                    int(os.environ.get("NGSF_BENCH_STREAM_ITERS", 4)),
                    prefix="stream",
                ))
            except Exception as e:  # noqa: BLE001
                log(f"[bench] stream leg failed: {e}")
                out["stream_error"] = str(e)[:200]
        if os.environ.get("NGSF_BENCH_STREAM50", "1") == "1":
            # the 50M rung toward BASELINE's 5000 x 50M config: same
            # chunk geometry as the 10M leg (no extra kernel compiles),
            # 5x the chunks. Per-chip scaling note: 50M x 100 streams;
            # the full 5000-ind config is 50 such column blocks on an
            # ind-sharded mesh (one psum per est_maf macro round), so
            # per-chip iteration time is ~this number at equal per-chip
            # width.
            try:
                out.update(time_stream(
                    int(os.environ.get("NGSF_BENCH_S50_SITES",
                                       50_000_000)),
                    int(os.environ.get("NGSF_BENCH_S50_IND", 100)),
                    int(os.environ.get("NGSF_BENCH_STREAM_CHUNK",
                                       1_000_000)),
                    int(os.environ.get("NGSF_BENCH_S50_ITERS", 4)),
                    prefix="stream50m",
                ))
            except Exception as e:  # noqa: BLE001
                log(f"[bench] 50M stream leg failed: {e}")
                out["stream50m_error"] = str(e)[:200]
        if os.environ.get("NGSF_BENCH_WIDE_STREAM", "1") == "1":
            # 1000-ind streamed rung (BASELINE ladder: 1000 x 10M):
            # chunked v2 pipeline at wide N. 125k x 1000 chunks measured
            # best (round 5): the per-pass working margin scales with
            # the chunk, so halving it frees enough budget to pin 15/80
            # chunks (vs 3/40 at 250k) -- 27.9 -> ~13.5-16 s/iter. The
            # leg needs ~2 iterations to reach cache steady state, so 4
            # timed iterations keep the median honest.
            try:
                out.update(time_stream(
                    int(os.environ.get("NGSF_BENCH_WSTREAM_SITES",
                                       10_000_000)),
                    int(os.environ.get("NGSF_BENCH_WSTREAM_IND", 1000)),
                    int(os.environ.get("NGSF_BENCH_WSTREAM_CHUNK",
                                       125_000)),
                    int(os.environ.get("NGSF_BENCH_WSTREAM_ITERS", 4)),
                    prefix="stream_wide",
                ))
            except Exception as e:  # noqa: BLE001
                log(f"[bench] wide stream leg failed: {e}")
                out["stream_wide_error"] = str(e)[:200]
    else:
        out.update({
            "value": round(small_cps, 1),
            "config": f"{S}x{N}",
            "ms_per_em_iter": round(t_small * 1e3, 2),
        })
    print(json.dumps(out))


if __name__ == "__main__":
    main()
