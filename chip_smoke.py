#!/usr/bin/env python3
"""Smoke run of the EM engine on one NVIDIA GPU.

Drives the main path once through the entry points a user calls and
checks what comes out against the repository's plain references:

  device   JAX's platform, device kind and count, and the card's name
           and power limit (nvidia-smi). Anything but a GPU fails.
  kernels  the four Triton chain kernels at the 1M-site x 100-individual
           geometry: compiled, memory_analysis() printed, compared with
           the XLA blocked-linear passes on the same seeded inputs, both
           timed; then one EM iteration of each tier timed.
  e2e      the CLI's f32 speed mode (--kernel pallas) on a simulated
           100 x 1M cohort: EM, Viterbi and the .indF/.ibd/.geno
           writers; the same input through --kernel linear must agree.
  default  the CLI's default f64 scan tier at 10 x 10k on the GPU,
           against the same run forced to the CPU.

  --four   instead of the phases above: the ind-sharded mesh
           (--mesh ind=4, Triton tier) at 1000 x 1M on four cards,
           against the same run on one card.

Each phase runs in a child process, one after another, so only one JAX
process holds the card at a time; this parent never imports JAX. The
children share one persistent compile cache (utils/compile_cache.py).
Work files go to .smoke/ in the checkout and are removed at the end.
Any failure exits non-zero; the last line of a passing run is one JSON
object naming the device.

Usage: python3 chip_smoke.py [--four]
"""

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
WORK = REPO / ".smoke"
SEED = 20260817
# cohort sizes: (sites, individuals) of the main path and of --four;
# --small shrinks both for rehearsals on the CPU
SIZES = {"main": (1_000_000, 100), "four": (1_000_000, 1000)}
SMALL_SIZES = {"main": (3000, 8), "four": (2000, 16)}

# f32 gates, Triton kernels against the XLA blocked-linear passes. Both
# rescale exactly by powers of two, so they differ only by f32 rounding
# in different association orders (blocks of ~400 vs ~800 sites):
#   loglik: sums of ~1e6 site terms, each rounded at ~6e-8 relative;
#   gradients: Fisher-identity sums of ~2,600 block ratios whose terms
#     cancel, so compared as max |diff| over max |reference| per
#     parameter;
#   posteriors: each site's posterior comes from carries that picked up
#     f32 rounding over up to a block of sites, so either tier sits
#     ~2e-5 from the f64 scan tier at 1M sites (both measured on an
#     H100). Each tier is held to TOL_POST_F64 of f64 on a few
#     individuals, the Triton tier to no more than 1.25x the XLA tier's
#     error there, and the two tiers to twice TOL_POST_F64 of each other.
TOL_LL_REL = 1e-5
TOL_GRAD_REL = 2e-3
TOL_POST_F64 = 3e-5
TOL_POST_RATIO = 1.25
# H100 SXM HBM3 bandwidth (NVIDIA data sheet), the est_maf bytes floor
HBM_BYTES_PER_S = 3.35e12
# end to end, two f32 runs (--kernel pallas against --kernel linear, or
# the ind mesh against one card) are held to what f32 can resolve: the
# M-step retires a row once it cannot improve its objective by 8 ulps,
# so F and alpha are fixed only to where the per-individual
# log-likelihood is flat within f32 resolution (at 1M sites F moved by
# up to ~2e-2 without changing it, on an H100). The gates are therefore
# the objective itself, each individual's log-likelihood within 64 f32
# ulps, and the Viterbi paths within README's 0.2 % of cells; F, alpha
# and freq differences are printed, and for the mesh how many
# individuals differ by more than tests/test_distributed.py's 2e-3.
TOL_LKL_F32 = 64 * 2.0 ** -23
TOL_VITERBI_FRAC = 2e-3
TOL_MESH = 2e-3
# the f64 scan tier on the GPU against the CPU: same program, other
# reduction order in XLA's fusions; parameters and log-likelihoods
TOL_F64 = 1e-6


def log(msg):
    print(msg, flush=True)


def smi_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except FileNotFoundError:
        return "no nvidia-smi"
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, reps=7):
    """Median wall time of fn() over reps warm calls, each ended by
    block_until_ready."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def synth(S, N, seed=SEED):
    """Seeded low-coverage GLs made on the device (Poisson 2x depth,
    error 0.01): (gl [S, N, 3] normalised log f32, dist [S] Mb)."""
    from ngsf_hmm.tools.simulate import synth_device

    return synth_device(S, N, seed)


# ---------------------------------------------------------------------------
# phases (each runs in its own child process)
# ---------------------------------------------------------------------------


def phase_device():
    import jax

    devs = jax.devices()
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    log(f"devices: {devs}")
    log(f"platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's platform is {d.platform!r}")
    (WORK / "device.json").write_text(json.dumps(info))


def phase_kernels():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ngsf_hmm.models import hmm_blocked as hb
    from ngsf_hmm.models import hmm_pallas as hp
    from ngsf_hmm.ops.emissions import emission_probs_linear

    S, N = SIZES["main"]
    gl, dist = synth(S, N)
    key = jax.random.key(SEED + 1)
    k1, k2, k3 = jax.random.split(key, 3)
    freq = jax.random.uniform(k1, (S,), jnp.float32, 0.05, 0.5)
    F = jax.random.uniform(k2, (N,), jnp.float32, 0.05, 0.5)
    alpha = jax.random.uniform(k3, (N,), jnp.float32, 0.01, 2.0)
    gl_lin = jnp.exp(gl)
    prep = hp.prepare_gl_inputs(gl_lin, dist)
    fc = hp.freq_compact(freq, prep)
    geo = (S, N, prep["bs"], prep["nb_p"])
    log(f"Triton geometry: bs={prep['bs']} nb_p={prep['nb_p']} "
        f"lanes={prep['L']} tile={prep['tile']} "
        f"programs={prep['L'] // prep['tile']}")
    bs = hb.pick_block_size(S)
    e_blk, _ = hb.block_sites(emission_probs_linear(gl_lin, freq[:, None]),
                              bs, 1.0)
    d_blk, _ = hb.block_sites(dist, bs, 0.0)
    slabs = (prep["g0"], prep["g2"], prep["dc"], fc)

    def P(g0, g2, dc):
        return hp.make_prep2(g0, g2, dc, *geo)

    # ---- each Triton kernel alone: compiled, memory, time
    Fr, ar = hp._rep_params2(F[None], alpha[None], prep)
    A_r, _ = hp.block_transfers_fused(F[None], alpha[None], prep, fc)
    starts, ends, _ = hp._combine_blocks(A_r, F[None])
    w = hp._ends_fold2(ends, prep)
    v = hp._ends_fold2(starts, prep)
    bwr = hp._k_bw(prep)(*slabs[:2], fc, prep["dc"], Fr[0], ar[0], *w)
    kernels = {
        "transfer": (lambda g0, g2, dc, fc, Fr, ar: hp._k_transfer(
            1, P(g0, g2, dc))(g0, g2, fc, dc, Fr, ar), (Fr, ar)),
        "transfer_grad": (lambda g0, g2, dc, fc, Fr, ar: hp._k_transfer_grad(
            P(g0, g2, dc))(g0, g2, fc, dc, Fr[0], ar[0]), (Fr, ar)),
        "bw": (lambda g0, g2, dc, fc, Fr, ar, w0, w1: hp._k_bw(
            P(g0, g2, dc))(g0, g2, fc, dc, Fr[0], ar[0], w0, w1),
            (Fr, ar) + w),
        "fw_post": (lambda g0, g2, dc, fc, Fr, ar, v0, v1, b: hp._k_fw_post(
            P(g0, g2, dc))(g0, g2, fc, dc, Fr[0], ar[0], v0, v1, b),
            (Fr, ar) + v + (bwr,)),
    }
    times = {}
    for name, (fn, extra) in kernels.items():
        args = slabs + extra
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        log(f"[kernel {name}] compiled in {time.perf_counter() - t0:.1f}s; "
            f"memory_analysis: {compiled.memory_analysis()}")
        times[name] = median_ms(lambda: compiled(*args))
        log(f"[kernel {name}] {times[name]:.3f} ms (median of 7)")

    # ---- each pass: Triton against the XLA blocked-linear form
    def tri_ll(g0, g2, dc, fc, F, a):
        return hp.forward_loglik_fused(F[None], a[None], P(g0, g2, dc), fc)[0]

    def tri_vag(g0, g2, dc, fc, F, a):
        return hp.loglik_value_and_grad_fused(F, a, P(g0, g2, dc), fc)

    def tri_post(g0, g2, dc, fc, F, a):
        return hp.posteriors_fused(F, a, P(g0, g2, dc), fc)

    def xla_ll(e, d, F, a):
        return hb.forward_loglik_blocked_lin(F, a, e, d)

    def xla_vag(e, d, F, a):
        return hb.loglik_value_and_grad_blocked_lin(F, a, e, d)

    def xla_post(e, d, F, a):
        return hb.posteriors_blocked_lin(e, d, F, a, S)

    targs = slabs + (F, alpha)
    xargs = (e_blk, d_blk, F, alpha)
    res = {}
    for name, tf, xf in (("loglik", tri_ll, xla_ll),
                         ("value_and_grad", tri_vag, xla_vag),
                         ("posteriors", tri_post, xla_post)):
        tj, xj = jax.jit(tf), jax.jit(xf)
        ot, ox = jax.device_get(tj(*targs)), jax.device_get(xj(*xargs))
        t_t = median_ms(lambda: tj(*targs))
        t_x = median_ms(lambda: xj(*xargs))
        res[name] = (ot, ox)
        log(f"[pass {name}] triton {t_t:.3f} ms | xla blocked-linear "
            f"{t_x:.3f} ms | ratio {t_x / t_t:.2f}x")

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    def rel_each(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.abs(b)))

    ll_t, ll_x = res["loglik"]
    (vl_t, gF_t, ga_t), (vl_x, gF_x, ga_x) = res["value_and_grad"]
    (p_t, pf_t, pb_t), (p_x, _, _) = res["posteriors"]
    checks = {
        "loglik rel": (rel_each(ll_t, ll_x), TOL_LL_REL),
        "vag loglik rel": (rel_each(vl_t, vl_x), TOL_LL_REL),
        "posterior loglik rel": (rel_each(pf_t, ll_x), TOL_LL_REL),
        "posterior fw/bw loglik rel": (rel_each(pb_t, pf_t), TOL_LL_REL),
        "posteriors abs": (float(np.max(np.abs(p_t - p_x))),
                           2 * TOL_POST_F64),
        "dL/dF rel": (rel(gF_t, gF_x), TOL_GRAD_REL),
        "dL/dalpha rel": (rel(ga_t, ga_x), TOL_GRAD_REL),
    }
    # f64 anchor: the scan tier (models/hmm.py) on the host's CPU for a
    # few individuals, so each f32 tier's own error is known
    K = min(N, 8)
    p64, ll64 = _f64_posteriors(gl_lin[:, :K], dist, freq, F[:K], alpha[:K])
    err64 = {}
    for tier, p32, l32 in (("triton", p_t, pf_t), ("xla", p_x, ll_x)):
        err64[tier] = float(np.max(np.abs(p32[:, :K] - p64)))
        log(f"[f64 anchor, {K} individuals] {tier}: posteriors max abs "
            f"{err64[tier]:.3e}, loglik max rel "
            f"{rel_each(l32[:K], ll64):.3e}")
        checks[f"posteriors abs vs f64 ({tier})"] = (err64[tier],
                                                     TOL_POST_F64)
    # (the floor keeps tiny cohorts, where both errors are a few ulps,
    # from reading ulp noise as a ratio)
    checks["posterior error triton / xla"] = (
        err64["triton"] / max(err64["xla"], 2e-6), TOL_POST_RATIO)
    checks["loglik rel vs f64 (triton)"] = (
        rel_each(pf_t[:K], ll64), TOL_LL_REL)
    bad = []
    for k, (err, tol) in checks.items():
        ok = np.isfinite(err) and err <= tol
        log(f"[check] {k}: {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(k)
    for name, (o, _) in res.items():
        for x in jax.tree_util.tree_leaves(o):
            if not np.all(np.isfinite(x)):
                bad.append(f"{name} not finite")

    # ---- the est_maf freq M-step (plain XLA) and its bytes floor
    from ngsf_hmm.ops.maf import est_maf, macro_schedule

    p_dev = jax.jit(tri_post)(*targs)[0]
    maf = jax.jit(lambda g, p: est_maf(jnp.exp(g), p, linear=True,
                                       macro=True))
    t_maf = median_ms(lambda: maf(gl, p_dev))
    sched = macro_schedule(N)
    passes = sched[0] + len(sched[1]) if sched else 101
    floor_ms = passes * S * N * 16 / HBM_BYTES_PER_S * 1e3
    log(f"[est_maf] {t_maf:.3f} ms; {passes} full reads of gl + p "
        f"({passes * S * N * 16 / 1e9:.1f} GB) take {floor_ms:.3f} ms at "
        f"3.35 TB/s: {floor_ms / t_maf:.1%} of the bytes roofline")

    # ---- one EM iteration per tier, as run_em's loop steps it
    from ngsf_hmm.models.em import _gl_slabs, em_iteration, init_state
    from ngsf_hmm.parallel.sharded_em import zero_opt_memory

    state0 = init_state(gl, jnp.full((S,), 0.2, jnp.float32),
                        jnp.full((N,), 0.2, jnp.float32),
                        jnp.full((N,), 0.05, jnp.float32))
    for tier in ("pallas", "linear"):
        # the run-constant inputs run_em threads from the first call
        hold = {"slabs": _gl_slabs(gl, dist) if tier == "pallas" else None,
                "opt": zero_opt_memory(N, jnp.float32), "st": state0}
        kw = dict(numerics=tier, return_opt=True, return_prep=True,
                  block_size=None if tier == "pallas" else "auto",
                  defer_emissions=tier == "pallas")

        def step():
            out = em_iteration(gl, dist, hold["st"],
                               prep_slabs=hold["slabs"],
                               opt_memory=hold["opt"], **kw)
            hold["st"], _, hold["slabs"], hold["opt"] = out
            return hold["st"].ind_lkl

        t0 = time.perf_counter()
        jax.block_until_ready(step())
        log(f"[em {tier}] first iteration (compile) "
            f"{time.perf_counter() - t0:.1f}s")
        ms = median_ms(step, reps=6)
        log(f"[em {tier}] {ms:.2f} ms per EM iteration (median of 6 "
            "warm iterations)")
    if bad:
        raise SystemExit(f"kernel checks failed: {bad}")


def _f64_posteriors(gl_lin, dist, freq, F, alpha):
    """(p [S, K], ll [K]) of the f64 scan tier on the CPU device."""
    import jax
    import numpy as np

    from ngsf_hmm.models.hmm import posteriors
    from ngsf_hmm.ops.emissions import emission_probs_linear

    jax.config.update("jax_enable_x64", True)
    cpu = jax.devices("cpu")[0]

    def put(x):
        return jax.device_put(np.asarray(x, np.float64), cpu)

    g = np.asarray(gl_lin, np.float64)
    g = put(g / g.sum(-1, keepdims=True))
    e_log = jax.numpy.log(emission_probs_linear(g, put(freq)[:, None]))
    p, ll, _ = jax.jit(posteriors)(e_log, put(dist), put(F), put(alpha))
    jax.config.update("jax_enable_x64", False)
    return np.asarray(p), np.asarray(ll)


def _run_cli(args, env_extra=None):
    """Run the CLI; returns (stdout lines stamped with the seconds since
    start at which each arrived, total wall seconds)."""
    cmd = [sys.executable, "-u", "-m", "ngsf_hmm"] + [str(a) for a in args]
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    t0 = time.perf_counter()
    with open(WORK / "cli.stderr", "w+") as err:
        proc = subprocess.Popen(cmd, cwd=WORK, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        lines = [(time.perf_counter() - t0, ln.rstrip("\n"))
                 for ln in proc.stdout]
        rc = proc.wait()
        err.seek(0)
        err_tail = err.read()[-4000:]
    dt = time.perf_counter() - t0
    if rc != 0:
        log("\n".join(ln for _, ln in lines[-40:]))
        log(err_tail)
        raise SystemExit(f"CLI failed ({rc}): {' '.join(cmd)}")
    return lines, dt


def _stages(lines, total):
    """Wall seconds of each CLI stage, from when its progress lines
    arrived: start-up + read + init, each EM iteration (the first one
    compiles), Viterbi, writers."""
    def first(prefix):
        return next(t for t, ln in lines if ln.startswith(prefix))

    t_it1 = first("Iteration 1:")
    iters = [t for t, ln in lines if ln.lstrip().startswith("LogLkl")]
    t_dec = first("==> Decoding")
    t_wr = first("Printing final results")
    t_end = first("Freeing memory")
    out = {"startup+read+init": t_it1}
    prev = t_it1
    for i, t in enumerate(iters):
        out[f"em iteration {i + 1}"] = t - prev
        prev = t
    out["viterbi"] = t_dec - prev
    out["writers"] = t_end - t_wr
    out["exit"] = total - t_end
    return out


def _read_indF(path, N):
    import numpy as np

    lines = path.read_text().splitlines()
    rows = [ln.split("\t") for ln in lines[1:N + 1]]
    F = np.array([float(r[0]) for r in rows])
    a = np.array([np.nan if r[1] == "NA" else float(r[1]) for r in rows])
    freq = np.array([float(x) for x in lines[N + 1:]])
    return float(lines[0]), F, a, freq


def _read_ibd(path, N):
    """(per-individual log-likelihoods, Viterbi paths [N, S]) of a .ibd."""
    import numpy as np

    with open(path, "rb") as fh:
        lkl = np.array([float(x) for x in fh.readline().split()[1:]])
        paths = np.stack([np.frombuffer(fh.readline().rstrip(b"\n"),
                                        np.uint8) for _ in range(N)])
    return lkl, paths


def _agreement(label, lkl, params, paths, lkl_rel, param_tol=None):
    """Log and gate two runs' agreement. lkl, paths: (run a, run b)
    pairs; params: {name: (a, b)} compared by max abs difference
    (gated only when param_tol is given). Returns the failed names."""
    import numpy as np

    bad = []
    rel = float(np.max(np.abs(lkl[0] - lkl[1]) / np.abs(lkl[1])))
    log(f"[{label}] per-individual loglik max rel diff: {rel:.3e} "
        f"(tol {lkl_rel:.3g})")
    if not rel <= lkl_rel:
        bad.append("loglik")
    for k, (x, y) in params.items():
        d = np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
        err = float(np.nanmax(d))
        gate = "" if param_tol is None else f" (tol {param_tol:g})"
        log(f"[{label}] {k} max abs diff: {err:.3e}, {int(np.sum(d > 1e-3))}"
            f" of {d.size} above 1e-3{gate}")
        if param_tol is not None and not err <= param_tol:
            bad.append(k)
    frac = float(np.mean(paths[0] != paths[1]))
    log(f"[{label}] viterbi cells differing: {frac:.3e} "
        f"(tol {TOL_VITERBI_FRAC:g})")
    if not frac <= TOL_VITERBI_FRAC:
        bad.append("viterbi")
    return bad


def _compare_runs(a, b, S, N, lkl_rel, param_tol, label):
    import numpy as np

    (_, Fa, aa, fa), (_, Fb, ab, fb) = (
        _read_indF(WORK / f"{x}.indF", N) for x in (a, b))
    (la, pa), (lb, pb) = (_read_ibd(WORK / f"{x}.ibd", N) for x in (a, b))
    bad = _agreement(label, (la, lb),
                     {"F": (Fa, Fb), "alpha": (aa, ab), "freq": (fa, fb)},
                     (pa, pb), lkl_rel, param_tol)
    if not np.array_equal(np.isnan(aa), np.isnan(ab)):
        bad.append("alpha NA pattern")
    for x in (a, b):
        if (WORK / f"{x}.geno").stat().st_size != S * N * 3 * 8:
            bad.append(f"{x}.geno size")
    if bad:
        raise SystemExit(f"{label}: outputs disagree: {bad}")


def phase_e2e():
    from ngsf_hmm.tools.simulate import simulate_binary

    S, N = SIZES["main"]
    t0 = time.perf_counter()
    simulate_binary(N, S, str(WORK / "sim"), seed=SEED)
    log(f"[e2e] simulated {N} x {S} (depth 2x, error 0.01) in "
        f"{time.perf_counter() - t0:.1f}s")
    base = ["--geno", "sim.glf", "--pos", "sim.pos.gz", "--n_ind", N,
            "--n_sites", S, "--freq", "0.1", "--indF", "0.1,0.2",
            "--seed", 7, "--min_iters", 10, "--max_iters", 20,
            "--dtype", "float32", "--verbose", 1]
    smi = smi_line()
    for kernel in ("pallas", "linear"):
        lines, dt = _run_cli(base + ["--kernel", kernel, "--out", kernel])
        for _, ln in lines:
            if ln.startswith("==> Kernel tier"):
                log(f"[e2e {kernel}] {ln}")
        stages = _stages(lines, dt)
        log(f"[e2e {kernel}] CLI wall {dt:.1f}s on {smi}; stages (s): "
            + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    _compare_runs("pallas", "linear", S, N, TOL_LKL_F32, None, "e2e")


def phase_default():
    from ngsf_hmm.tools.simulate import simulate

    N, S = 10, 10_000
    simulate(n_ind=N, n_sites=S, freq="0.2", indF="0.5", alpha="0.01",
             depth="2", error=0.01, seed=12345, out=str(WORK / "small"))
    base = ["--geno", "small.glf.gz", "--loglkl", "--pos", "small.pos.gz",
            "--n_ind", N, "--n_sites", S, "--freq", "0.1",
            "--indF", "0.1,0.2", "--seed", 12345, "--min_iters", 5,
            "--max_iters", 6, "--min_epsilon", 100, "--verbose", 1]
    _, t_gpu = _run_cli(base + ["--out", "f64_gpu"])
    _, t_cpu = _run_cli(base + ["--device", "cpu", "--out", "f64_cpu"],
                        {"JAX_PLATFORMS": "cpu"})
    log(f"[default] f64 scan tier, {N} x {S}, 5 EM iterations: GPU "
        f"{t_gpu:.1f}s, CPU {t_cpu:.1f}s (wall, process included)")
    _compare_runs("f64_gpu", "f64_cpu", S, N, TOL_F64, TOL_F64, "default")


def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ngsf_hmm.models.em import EMOptions, init_state, run_em
    from ngsf_hmm.parallel.driver import run_em_sharded

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, have {len(jax.devices())}")
    S, N = SIZES["four"]
    opts = EMOptions(numerics="pallas", min_iters=3, max_iters=4,
                     min_epsilon=100.0, verbose=0)
    gl, dist = synth(S, N)

    @jax.jit
    def init(gl):
        # jitted: the eager emission math would hold [S, N, 2, 3]
        dt = jnp.float32
        return init_state(gl, jnp.full((S,), 0.1, dt),
                          jnp.full((N,), 0.2, dt), jnp.full((N,), 0.05, dt))

    t0 = time.perf_counter()
    one = run_em(gl, dist, init(gl), opts)
    t_one = time.perf_counter() - t0
    # keep only host copies of the one-card result before the mesh run
    one = dataclasses.replace(one, state=jax.device_get(one.state))
    t0 = time.perf_counter()
    four = run_em_sharded(gl, dist, init(gl), opts,
                          {"restart": 1, "ind": 4, "site": 1})
    t_four = time.perf_counter() - t0
    log(f"[four] {N} x {S}, {one.n_iters} EM iterations + Viterbi: one "
        f"card {t_one:.1f}s, ind=4 mesh {t_four:.1f}s (compile included)")
    st1, st4 = one.state, four.state
    flat = np.abs(np.asarray(st4.ind_lkl, np.float64)
                  - np.asarray(st1.ind_lkl, np.float64))
    bad = _agreement(
        "four", (np.asarray(st4.ind_lkl), np.asarray(st1.ind_lkl)),
        {k: (getattr(st4, k), getattr(st1, k))
         for k in ("indF", "alpha", "freq")},
        (np.asarray(four.path), np.asarray(one.path)), TOL_LKL_F32)
    dF = np.abs(np.asarray(st4.indF, np.float64)
                - np.asarray(st1.indF, np.float64))
    da = np.abs(np.asarray(st4.alpha, np.float64)
                - np.asarray(st1.alpha, np.float64))
    moved = (dF > TOL_MESH) | (da > TOL_MESH)
    log(f"[four] {int(moved.sum())} of {N} individuals differ by more "
        f"than {TOL_MESH:g} in F or alpha; their log-likelihoods differ "
        f"by at most {float(flat[moved].max()) if moved.any() else 0.0:.3g}")
    if bad:
        raise SystemExit(f"four: mesh disagrees with one card: {bad}")
    d = jax.devices()[0]
    (WORK / "device.json").write_text(json.dumps(
        {"platform": d.platform, "kind": d.device_kind,
         "count": len(jax.devices())}))


PHASES = {"device": phase_device, "kernels": phase_kernels,
          "e2e": phase_e2e, "default": phase_default, "four": phase_four}


def child(name, small):
    sys.path.insert(0, str(REPO))
    if small:
        SIZES.update(SMALL_SIZES)
    WORK.mkdir(exist_ok=True)
    from ngsf_hmm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"card: {smi_line()}")
    PHASES[name]()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card ind-mesh phase")
    ap.add_argument("--small", action="store_true",
                    help="tiny cohorts, for rehearsing on the CPU")
    ap.add_argument("--phase", choices=sorted(PHASES),
                    help="run one phase in this process")
    args = ap.parse_args()
    if args.phase:
        child(args.phase, args.small)
        return 0
    if not (REPO / "ngsf_hmm" / "__init__.py").exists():
        print("chip_smoke.py: the ngsf_hmm package is not beside this "
              "script", file=sys.stderr)
        return 2
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    phases = ["four"] if args.four else ["device", "kernels", "e2e",
                                         "default"]
    try:
        for name in phases:
            log(f"=== phase {name}")
            t0 = time.perf_counter()
            cmd = [sys.executable, str(REPO / "chip_smoke.py"),
                   "--phase", name] + (["--small"] if args.small else [])
            r = subprocess.run(cmd, cwd=REPO)
            log(f"=== phase {name}: rc {r.returncode}, "
                f"{time.perf_counter() - t0:.1f}s")
            if r.returncode != 0:
                return 1
        info = json.loads((WORK / "device.json").read_text())
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if info.get("platform") != "gpu":
        return 1
    log(smi_line())
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
