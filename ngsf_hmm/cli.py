"""Command-line interface with reference flag/stdout parity.

Accepts the same 22 options as the reference binary (reference:
parse_args.cpp:43-68), with getopt_long_only semantics: options work with
one or two leading dashes and unambiguous prefixes, values via "--opt v"
or "--opt=v". Verbose levels 1-3 reproduce the reference's progress lines.

Example (the reference README's invocation shape):
    python -m ngsf_hmm --geno data.glf.gz --loglkl --n_ind 20 \
        --n_sites 100000 --pos data.pos.gz --out run1
"""

import os
import sys
import time

import numpy as np

from .utils.constants import EPSILON, VERSION

# (long_name, has_arg, short_char)
_OPTIONS = [
    ("geno", True, "g"),
    ("pos", True, "Z"),
    ("lkl", False, "l"),
    ("loglkl", False, "L"),
    ("n_ind", True, "n"),
    ("n_sites", True, "s"),
    ("call_geno", False, "G"),
    ("freq", True, "f"),
    ("freq_est", True, "F"),
    ("e_prob", True, "e"),
    ("indF", True, "i"),
    ("indF_fixed", False, "I"),
    ("alpha_fixed", False, "A"),
    ("out", True, "o"),
    ("log", True, "X"),
    # --log_bin N sets log=N and a log_bin flag that NOTHING in the
    # reference ever reads (parse_args.cpp:119-121 stores it, print_iter
    # writes text regardless); parsed + echoed here for exact parity
    ("log_bin", True, "b"),
    ("min_iters", True, "m"),
    ("max_iters", True, "M"),
    ("min_epsilon", True, "E"),
    ("n_threads", True, "x"),
    ("verbose", True, "V"),
    ("seed", True, "S"),
    # engine-only extensions (not in the reference):
    ("dtype", True, None),  # float64 (compat, default) | float32
    ("device", True, None),  # cpu | gpu (default: jax default backend)
    ("kernel", True, None),  # scan (compat, default) | blocked | linear | pallas
    # M-step optimizer: "speed" (batched projected L-BFGS, default) |
    # "compat" (reference-trajectory L-BFGS-B 2.1 + FD gradients,
    # models/em_compat.py -- byte-identical estimated outputs)
    ("opt", True, None),
    # bfloat16 gl-slab storage for the pallas tier (0 | 1 | auto):
    # halves the v2 kernels' slab HBM + stream bytes; gl quantised at
    # ~2^-9 relative, kernel math stays f32. "auto" (default) = off for
    # in-HBM runs, on for streamed runs whose f32 slabs only partially
    # fit the device cache budget (models/streaming.py docstring).
    ("gl_bf16", True, None),
    # multi-restart replicates on one device (the ngsF-HMM.sh protocol,
    # ngsF-HMM.sh:9,83-116, as a vmapped axis; replicate r seeds its
    # random inits with seed+r). 1 = plain single run.
    ("n_rep", True, None),
    # exact-resume checkpointing (io/checkpoint.py): --checkpoint FILE
    # saves state+bookkeeping every --checkpoint_every iterations
    # (default 1; atomic); --resume continues from that file. With
    # --n_rep > 1 each save serialises the full stacked state, so large
    # multi-restart runs should raise the cadence.
    ("checkpoint", True, None),
    ("checkpoint_every", True, None),
    ("resume", False, None),
    # streaming EM (models/streaming.py): process --stream_chunk sites per
    # device pass so gl/e_prob never reside whole in HBM (out-of-HBM
    # configs). Implies the linear speed kernels.
    ("stream_chunk", True, None),
    # out-of-host-RAM composition for --stream_chunk: read GL chunks
    # straight from the input file (binary: memmap; text: slab reader)
    # instead of preloading the [S, N, 3] matrix, and spill the [S, N]
    # p_ibd / Viterbi buffers to disk-backed memmaps. The 5000 x 50M
    # BASELINE config (~6 TB of GLs) is only loadable this way.
    ("stream_file", False, None),
    # multi-chip runs (parallel/driver.py): "--mesh ind=8",
    # "--mesh restart=2,ind=4", "--mesh ind=2,site=4", or "RxI[xS]"
    # shorthand. Shards the full EM run (convergence loop + Viterbi +
    # outputs) over a jax.sharding.Mesh of that shape.
    ("mesh", True, None),
    # multi-host runs (parallel/distributed.py): every participating
    # process runs the SAME command line plus its own --proc_id;
    # process 0 also hosts the coordination service at --coordinator
    # host:port. Requires --mesh (the (restart, ind) layouts); each
    # process reads only its slab of the GL matrix (native slab readers)
    # and only process 0 writes stdout/output files.
    ("coordinator", True, None),
    ("n_procs", True, None),
    ("proc_id", True, None),
    # tracing/profiling (SURVEY.md S5.1): dump a JAX profiler trace of the
    # EM loop to DIR (view with TensorBoard / xprof). The reference's
    # equivalent is its verbose>=3 per-phase wall-clock timers
    # (EM.cpp:277-284); on an accelerator a fused iteration has no
    # host-visible phases, so the profiler trace IS the phase breakdown.
    ("profile", True, None),
]


def error(func, msg):
    sys.stdout.flush()
    sys.stderr.write(f"\n=====\nERROR: [{func}] {msg}\n=====\n\n")
    sys.stderr.flush()
    sys.exit(1)


def warn(func, msg):
    sys.stdout.flush()
    sys.stderr.write(f"\n=======\nWARNING: [{func}] {msg}\n=======\n\n")
    sys.stderr.flush()


def _atoi(v):
    """C atoi semantics (parse_args.cpp:87-137 uses atoi for every int
    flag): leading integer if any, else 0 -- garbage then trips the
    reference-style validation errors instead of a Python traceback."""
    import re

    m = re.match(r"\s*([-+]?\d+)", v or "")
    return int(m.group(1)) if m else 0


def _atof(v):
    import re

    m = re.match(r"\s*([-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?)", v or "")
    return float(m.group(1)) if m else 0.0


def _apply_opt(pars, opt, val):
    """Store one parsed option value (shared by short/long paths)."""
    if opt == "lkl":
        pars["lkl"] = True
    elif opt == "resume":
        pars["resume"] = True
    elif opt == "loglkl":
        pars["lkl"] = True
        pars["loglkl"] = True
    elif opt in ("call_geno", "indF_fixed", "alpha_fixed", "stream_file"):
        pars[opt] = True
    elif opt == "log_bin":
        pars["log"] = _atoi(val)
        pars["log_bin"] = True
    elif opt in ("n_ind", "n_sites", "freq_est", "e_prob", "log",
                 "min_iters", "max_iters", "n_threads", "verbose", "seed",
                 "n_rep", "stream_chunk", "checkpoint_every", "n_procs",
                 "proc_id"):
        pars[opt] = _atoi(val)
    elif opt == "min_epsilon":
        pars[opt] = _atof(val)
    else:
        pars[opt] = val


def parse_args(argv):
    """getopt_long_only-style parser over _OPTIONS."""
    pars = {
        "geno": None,
        "pos": None,
        "lkl": False,
        "loglkl": False,
        "n_ind": 0,
        "n_sites": 0,
        "call_geno": False,
        "freq": None,
        "freq_est": 1,
        "e_prob": 1,
        "indF": None,
        "indF_fixed": False,
        "alpha_fixed": False,
        "out": None,
        "log": 0,
        "log_bin": False,
        "min_iters": 10,
        "max_iters": 100,
        "min_epsilon": 1e-5,
        "n_threads": 1,
        "verbose": 1,
        # the reference defaults to rand()%1000 from an unseeded glibc
        # rand(), i.e. deterministically 1804289383 % 1000 = 383
        # (parse_args.cpp:30)
        "seed": 383,
        "dtype": "float64",
        "device": None,
        "kernel": "scan",
        "opt": "speed",
        "gl_bf16": "auto",
        "n_rep": 1,
        "checkpoint": None,
        "checkpoint_every": 1,
        "resume": False,
        "profile": None,
        "stream_chunk": 0,
        "stream_file": False,
        "mesh": None,
        "coordinator": None,
        "n_procs": 1,
        "proc_id": 0,
    }
    short_map = {s: (name, has) for name, has, s in _OPTIONS if s}
    longs = [(name, has) for name, has, _ in _OPTIONS]

    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-") or tok == "-":
            error("parse_cmd_args", f"unexpected argument: {tok}")
        name = tok.lstrip("-")
        val = None
        if "=" in name:
            name, val = name.split("=", 1)

        # glibc getopt_long_only: a single-dash token whose FIRST char is
        # a valid short option is parsed as short option(s) -- long
        # matching only happens for "--" tokens or unknown first chars
        # (reference optstring at parse_args.cpp:71). Handles bundling
        # (-lL) and glued arguments (-s1000) like getopt does.
        if (
            not tok.startswith("--")
            and val is None
            and name
            and name[0] in short_map
        ):
            j = 0
            while j < len(name):
                opt, has_arg = short_map.get(name[j], (None, None))
                if opt is None:
                    error("parse_cmd_args", f"unrecognized option: -{name[j]}")
                if has_arg:
                    if j + 1 < len(name):
                        sval = name[j + 1 :]  # glued: -s1000
                    else:
                        i += 1
                        if i >= len(argv):
                            error(
                                "parse_cmd_args",
                                f"option -{name[j]} requires an argument",
                            )
                        sval = argv[i]
                    _apply_opt(pars, opt, sval)
                    break
                _apply_opt(pars, opt, None)
                j += 1
            i += 1
            continue

        matches = [(n, h) for n, h in longs if n == name]
        if not matches:
            matches = [(n, h) for n, h in longs if n.startswith(name)]
        if len(matches) > 1:
            error("parse_cmd_args", f"ambiguous option: {tok}")
        if not matches:
            error("parse_cmd_args", f"unrecognized option: {tok}")
        opt, has_arg = matches[0]
        if has_arg and val is None:
            i += 1
            if i >= len(argv):
                error("parse_cmd_args", f"option {tok} requires an argument")
            val = argv[i]
        i += 1
        _apply_opt(pars, opt, val)

    # default init strings (parse_args.cpp:150-157)
    if pars["freq"] is None:
        pars["freq"] = "r"
    if pars["indF"] is None:
        pars["indF"] = "0.01-0.001"
    return pars


def _echo_args(p):
    print("==> Input Arguments:")
    print(
        f"\tgeno: {p['geno']}\n\tpos: {p['pos']}\n"
        f"\tlkl: {'true' if p['lkl'] else 'false'}\n"
        f"\tloglkl: {'true' if p['loglkl'] else 'false'}\n"
        f"\tn_ind: {p['n_ind']}\n\tn_sites: {p['n_sites']}\n"
        f"\tcall_geno: {'true' if p['call_geno'] else 'false'}\n"
        f"\tfreq: {p['freq']}\n\tfreq_est: {p['freq_est']}\n"
        f"\te_prob: {p['e_prob']}\n\tindF: {p['indF']}\n"
        f"\tindF_fixed: {'true' if p['indF_fixed'] else 'false'}\n"
        f"\talpha_fixed: {'true' if p['alpha_fixed'] else 'false'}\n"
        f"\tout: {p['out']}\n\tlog: {p['log']}\n"
        f"\tlog_bin: {'true' if p['log_bin'] else 'false'}\n"
        f"\tmin_iters: {p['min_iters']}\n\tmax_iters: {p['max_iters']}\n"
        f"\tmin_epsilon: {p['min_epsilon']:.10f}\n"
        f"\tn_threads: {p['n_threads']}\n\tverbose: {p['verbose']}\n"
        f"\tseed: {p['seed']}\n\tversion: {VERSION} (jax)\n"
    )


def validate(p):
    if p["geno"] is None:
        error("parse_cmd_args", "genotype input file (--geno) missing!")
    if p["pos"] is None:
        error("parse_cmd_args", "positions input file (--pos) missing!")
    if p["n_ind"] == 0:
        error("parse_cmd_args", "number of individuals (--n_ind) missing!")
    if p["n_sites"] == 0:
        error("parse_cmd_args", "number of sites (--n_sites) missing!")
    if p["call_geno"] and not p["lkl"]:
        error("parse_cmd_args", "can only call genotypes from likelihoods!")
    if p["freq_est"] < 0 or p["freq_est"] > 2:
        error("parse_cmd_args", "invalid MAF estimation method!")
    if p["e_prob"] < 0 or p["e_prob"] > 2:
        error("parse_cmd_args", "invalid emission probability calculation method!")
    if p["e_prob"] > 1:
        warn(
            "parse_cmd_args",
            "calculation of emission probabilities accounting for LD is "
            "still under development!",
        )
    if p["out"] is None:
        error("parse_cmd_args", "output prefix (--out) missing!")
    if p["log"] < 0:
        error("parse_cmd_args", "invalid LOG (--log) option!")
    if (
        p["min_iters"] < 1
        or p["max_iters"] < 1
        or p["min_iters"] >= p["max_iters"]
    ):
        error("parse_cmd_args", "invalid number of iterations!")
    if p["n_threads"] < 1:
        error("parse_cmd_args", "invalid number of threads!")


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    p = parse_args(argv)
    if p["coordinator"] is not None and p["proc_id"] != 0:
        # one stdout stream per run: non-zero processes run the same host
        # program silently (and skip the file writers, see write_outputs)
        import os as _os

        sys.stdout = open(_os.devnull, "w")
    if p["verbose"] >= 1:
        _echo_args(p)
    if p["verbose"] >= 4:
        print(
            "==> Verbose values greater than 4 for debugging purpose only. "
            "Expect large amounts of info on screen"
        )
    validate(p)

    if p["n_threads"] > p["n_ind"]:
        warn("main", "adjusting threads (--n_threads) to match number of individuals!")
        p["n_threads"] = p["n_ind"]

    # Configure JAX before first use.
    import jax

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if p["device"]:
        jax.config.update("jax_platforms", p["device"])
    if p["dtype"] == "float64":
        jax.config.update("jax_enable_x64", True)

    # ---- multi-host: join the coordination service before any backend
    # use (parallel/distributed.py; SURVEY.md §5.8)
    distributed_run = p["coordinator"] is not None
    dist_pid = p["proc_id"]
    if distributed_run:
        from .parallel import distributed as dist_mod

        if p["mesh"] is None:
            error("main", "--coordinator requires --mesh")
        if p["n_rep"] > 1:
            error("main", "--coordinator does not support --n_rep (shard "
                          "replicates within one host or run one process "
                          "per replicate)")
        if p["stream_chunk"] and not p["stream_file"]:
            error("main", "--coordinator + --stream_chunk requires "
                          "--stream_file (each process streams its ind "
                          "slab of every chunk straight from the input)")
        if p["n_procs"] < 1 or not (0 <= dist_pid < p["n_procs"]):
            error("main", "--proc_id must be in [0, --n_procs)")
        try:
            dist_mod.initialize(p["coordinator"], p["n_procs"], dist_pid)
        except Exception as e:  # noqa: BLE001 - surface as reference error
            error("main", f"jax.distributed init failed: {e}")
    if p["stream_chunk"] > 0 and p["n_rep"] > 1 and p["checkpoint"]:
        error("main", "--checkpoint is not supported with --stream_chunk "
                      "--n_rep (sequential restarts); checkpoint a "
                      "single-replicate run instead")
    import jax.numpy as jnp

    from .io import readers
    from .io.gsl_rng import GslTaus
    from .io.init import init_freq, init_indF_alpha
    from .io.writers import write_geno, write_ibd, write_indF
    from .models.em import EMOptions, EMState, init_state, run_em
    from .ops.hwe import call_geno as call_geno_op

    dtype = jnp.float64 if p["dtype"] == "float64" else jnp.float32

    mesh_spec = None
    if p["mesh"]:
        from .parallel.driver import parse_mesh_spec

        try:
            mesh_spec = parse_mesh_spec(p["mesh"])
        except ValueError as e:
            error("main", str(e))
        if p["stream_chunk"] and (
            mesh_spec["restart"] > 1 or mesh_spec["site"] > 1
        ):
            error(
                "main",
                "--stream_chunk composes with ind-only meshes "
                "(--mesh ind=K): the site axis is streamed, restart "
                "replicates are incompatible with streaming",
            )
        if p["freq_est"] == 2 or p["e_prob"] == 2:
            # fail at arg-parse time, not after IO + the pair-EM init:
            # run_em_sharded rejects the LD path (parallel/driver.py),
            # and on a multi-host job that late failure wastes the
            # whole cluster spin-up
            error(
                "main",
                "the LD path (--freq_est 2 / --e_prob 2) is not "
                "implemented on meshes (site-shard boundaries break the "
                "pair-EM recurrence); run it single-device",
            )
    if p["stream_file"] and not p["stream_chunk"]:
        error("main", "--stream_file requires --stream_chunk")
    if p["stream_chunk"] and (p["freq_est"] == 2 or p["e_prob"] == 2):
        error("main", "--stream_chunk does not support the LD path "
                      "(--freq_est 2 / --e_prob 2)")

    # ---- multi-host input layout: each process reads only its slab of
    # the GL matrix (the ind-axis range its devices own on the mesh)
    gmesh = None
    ind_slab = None
    site_slab = None
    S_pad_dist = p["n_sites"]
    if distributed_run:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as _P

        from .parallel.mesh import make_mesh

        n_need = (mesh_spec["restart"] * mesh_spec["ind"]
                  * mesh_spec["site"])
        if n_need > len(jax.devices()):
            error("main", f"mesh needs {n_need} devices, have "
                          f"{len(jax.devices())} across {p['n_procs']} "
                          "processes")
        s_m, i_m = mesh_spec["site"], mesh_spec["ind"]
        if s_m > 1:
            # site (or ind x site grid) mesh across processes: each host
            # loads its (site, ind) rectangle of the GL matrix; the site
            # axis is padded to a shard multiple with exact-identity
            # sites (same padding as parallel/driver._pad_sites)
            from .parallel.site_sharded import make_grid_mesh, make_site_mesh

            if p["n_rep"] > 1:
                error(
                    "main",
                    "site meshes do not compose with --n_rep (replicated "
                    "site-sharded chains are not implemented). Recipes: "
                    "sequential restarts through the streaming engine "
                    "(--stream_chunk N --n_rep R), or run R separate "
                    "jobs with --seed seed+r and keep the best "
                    "first-line .indF lkl (the ngsF-HMM.sh protocol)",
                )
            S_pad_dist = -(-p["n_sites"] // s_m) * s_m
            if i_m == 1:
                gmesh = make_site_mesh(s_m, devices=jax.devices()[:n_need])
                _gl_sh = NamedSharding(gmesh, _P("site", None, None))
            else:
                gmesh = make_grid_mesh(i_m, s_m,
                                       devices=jax.devices()[:n_need])
                _gl_sh = NamedSharding(gmesh, _P("site", "ind", None))
            gshape = (S_pad_dist, p["n_ind"], 3)
            try:
                site_slab = dist_mod.axis_slab(_gl_sh, gshape, 0)
                ind_slab = (
                    dist_mod.axis_slab(_gl_sh, gshape, 1) if i_m > 1
                    else (0, p["n_ind"])
                )
            except ValueError as e:
                error("main", str(e))
        else:
            gmesh = make_mesh(mesh_spec["restart"], mesh_spec["ind"],
                              devices=jax.devices()[:n_need])
            _gl_sh = NamedSharding(gmesh, _P(None, "ind", None))
            try:
                ind_slab = dist_mod.axis_slab(
                    _gl_sh, (p["n_sites"], p["n_ind"], 3), 1
                )
            except ValueError as e:
                error("main", str(e))

    # ---- sniff input format (ngsF-HMM.cpp:47-63)
    try:
        in_bin = readers.sniff_binary(p["geno"], p["n_ind"], p["n_sites"])
    except (ValueError, OSError) as e:
        error("main", str(e))
    if p["verbose"] >= 1:
        print("==> GZIP input file (not BINARY)" if not in_bin
              else "==> BINARY input file (always lkl)")
    if in_bin:
        p["lkl"] = True

    # ---- read data (ngsF-HMM.cpp:70-117)
    if p["verbose"] >= 1:
        print("==> Reading data")
        print("> Sites coordinates")
    try:
        dist_bp = readers.read_pos_dist(p["pos"], p["n_sites"])
    except ValueError as e:
        error("read_dist", str(e))
    dist = dist_bp / 1e6  # Mb (ngsF-HMM.cpp:84-86)
    if p["verbose"] >= 7:
        for s in range(min(10, p["n_sites"])):
            print(f"{dist[s]:.6f}")

    if p["verbose"] >= 1:
        print("> GENO data")
    gl_src = None
    _spill = None
    if p["stream_file"]:
        # out-of-host-RAM: never read the matrix; chunks come straight
        # from the file with the full read pipeline applied per chunk.
        # The spill directory (processed-chunk cache + p_ibd/path
        # buffers) lives NEXT TO the output files -- /tmp is tmpfs
        # (RAM-backed) on most hosts, which would defeat the point.
        # NGSF_STREAM_SPILL_DIR overrides.
        import tempfile

        from .io.glsource import ChunkedGLSource

        spill_base = os.environ.get("NGSF_STREAM_SPILL_DIR") or (
            os.path.dirname(os.path.abspath(p["out"])) or "."
        )
        _spill = tempfile.TemporaryDirectory(
            prefix=f"ngsf_stream_p{dist_pid}_", dir=spill_base
        )
        try:
            gl_src = ChunkedGLSource(
                p["geno"], p["n_ind"], p["n_sites"], binary=in_bin,
                probs=p["lkl"], log_scale=p["loglkl"],
                call_geno=p["call_geno"],
                ind_slab=ind_slab,  # multi-host: this process's columns
                cache_dir=_spill.name,
            )
            gl_src[0:1]  # probe: surface format errors up front
        except (ValueError, OSError) as e:
            error("read_geno", str(e))
    try:
        if gl_src is not None:
            gl = None
        elif ind_slab is not None:
            if site_slab is not None:
                # clamp this host's padded-coordinate range to real sites
                lo, cnt = site_slab
                hi = min(lo + cnt, p["n_sites"])
                lo_r = min(lo, p["n_sites"])
                gl = readers.read_geno_slab(
                    p["geno"],
                    p["n_ind"],
                    p["n_sites"],
                    (lo_r, hi - lo_r),
                    ind_slab,
                    binary=in_bin,
                    probs=p["lkl"],
                    log_scale=p["loglkl"],
                )
                pad = cnt - (hi - lo_r)
                if pad:
                    # exact-identity pad sites (driver.PAD_* values)
                    from .parallel.driver import PAD_GL

                    gl = np.concatenate([
                        gl,
                        np.full((pad, gl.shape[1], 3), PAD_GL, gl.dtype),
                    ])
            else:
                gl = readers.read_geno_slab(
                    p["geno"],
                    p["n_ind"],
                    p["n_sites"],
                    (0, p["n_sites"]),
                    ind_slab,
                    binary=in_bin,
                    probs=p["lkl"],
                    log_scale=p["loglkl"],
                )
        else:
            gl = readers.read_geno(
                p["geno"],
                p["n_ind"],
                p["n_sites"],
                binary=in_bin,
                probs=p["lkl"],
                log_scale=p["loglkl"],
            )
    except ValueError as e:
        error("read_geno", str(e))

    from .ops.hwe import post_prob

    if gl_src is not None:
        # the source applies call_geno/post_prob per chunk itself; for
        # distributed streaming it already exposes only this process's
        # ind columns
        gl_j = gl_src
        dist_j = None  # streaming consumes the host `dist` directly
    elif distributed_run:
        # assemble the global [S, N, 3] array from the per-host slabs and
        # process it on-device (sharding-preserving elementwise ops);
        # no host ever holds the full matrix
        gl_g = dist_mod.global_from_slab(
            _gl_sh, gl.astype(np.dtype(dtype)),
            (S_pad_dist, p["n_ind"], 3),
        )

        def _process(g):
            if p["call_geno"]:
                g = call_geno_op(g)
            return post_prob(g, None)  # re-normalise (ngsF-HMM.cpp:116)

        gl_j = jax.jit(_process, out_shardings=_gl_sh)(gl_g)
        if site_slab is not None:
            dist_pad = np.zeros(S_pad_dist, np.dtype(dtype))
            dist_pad[: p["n_sites"]] = dist
            _d_sh = NamedSharding(gmesh, _P("site"))
            lo, cnt = site_slab
            dist_j = dist_mod.global_from_slab(
                _d_sh, dist_pad[lo:lo + cnt], (S_pad_dist,)
            )
        else:
            dist_j = jax.device_put(
                np.asarray(dist, np.dtype(dtype)),
                NamedSharding(gmesh, _P()),
            )
    else:
        gl_j = jnp.asarray(gl, dtype=dtype)
        if p["call_geno"]:
            gl_j = call_geno_op(gl_j)
        # always re-normalise (ngsF-HMM.cpp:116)
        gl_j = post_prob(gl_j, None)
        dist_j = jnp.asarray(dist, dtype=dtype)

    # ---- init output values (parse_args.cpp:229-419)
    if p["verbose"] >= 6:
        print("> Init output")
    rng = GslTaus(p["seed"])
    spec = p["indF"]
    if p["verbose"] >= 1:
        if spec == "r":
            print("==> Using random initial inbreeding values.")
        elif os.path.isfile(spec):
            print(f'==> Reading initial inbreeding values from file "{spec}".')
        else:
            print(f"==> Setting initial inbreeding values to: {spec}")
    try:
        indF0, alpha0 = init_indF_alpha(spec, p["n_ind"], rng)
    except ValueError as e:
        error("init_output", str(e))

    fspec = p["freq"]
    if p["verbose"] >= 1:
        if fspec == "r":
            print("==> Using random initial frequency values.")
        elif fspec == "e":
            print("==> Estimating initial frequency values assuming HWE.")
        elif os.path.isfile(fspec):
            print(f'==> Reading initial frequency values from file "{fspec}".')
        else:
            print(f"==> Setting initial frequency values to: {fspec}")
    if p["freq_est"] == 2 or p["e_prob"] == 2:
        warn(
            "main",
            "the LD path (--freq_est 2 / --e_prob 2) is non-functional in "
            "the reference (NaN haplotype frequencies; gen_func.cpp:1160); "
            "running the CORRECTED two-site haplotype EM instead -- at init "
            "too (parse_args.cpp:316-321,373-386) -- results will not "
            "match the (broken) reference. See ngsf_hmm/ops/haplo.py.",
        )
    state = None
    freq0 = None
    # Streamed multi-restart (--stream_chunk + --n_rep) re-resolves only
    # the RANDOM inits per replicate; a deterministic freq init ("e",
    # file, literal) is identical across replicates and computed once
    # here (the "e" spec is a full chunked pass over the data).
    stream_restarts = p["stream_chunk"] > 0 and p["n_rep"] > 1
    if p["n_rep"] == 1 or (stream_restarts and fspec != "r"):
        # multi-restart re-resolves inits per replicate (seed+r), so the
        # single-run init (incl. the freq 'e' est_maf pass and the
        # [S, N, 2] emission build) is only done here
        try:
            if p["resume"] and fspec == "e":
                # the checkpoint overwrites the initial params anyway;
                # skip the full est_maf stream/pass over the data (a
                # complete extra read at --stream_file scale). The
                # placeholder only feeds the discarded init state.
                from .io.init import FREQ_RNG_MIN

                freq0 = np.full(p["n_sites"], FREQ_RNG_MIN)
            elif gl_src is not None and fspec == "e":
                # est_maf is per-site independent: the chunked estimate
                # over the file source equals the monolithic one
                # (multi-host: chunks assemble globally, psum over ind)
                from .io.glsource import est_maf_streamed

                freq0 = est_maf_streamed(
                    gl_src, p["stream_chunk"],
                    mesh=gmesh if distributed_run else None,
                    n_ind_total=p["n_ind"],
                )
            elif distributed_run and fspec == "e":
                # est_maf over the globally-sharded GLs: jitted so the
                # cross-host ind-axis sums become collectives, gathered
                # so every process sees the same full freq vector
                if p["freq_est"] == 2:
                    from .ops.haplo import ld_init_freq as _freq_e
                else:
                    from .ops.maf import est_maf

                    def _freq_e(g):
                        return est_maf(g, jnp.zeros(g.shape[:2], g.dtype))

                freq0 = dist_mod.host_array(
                    jax.jit(
                        _freq_e,
                        out_shardings=NamedSharding(gmesh, _P()),
                    )(gl_j)
                )[: p["n_sites"]]
            else:
                freq0 = init_freq(fspec, p["n_sites"], rng, gl=gl_j,
                                  freq_est=p["freq_est"])
        except ValueError as e:
            error("init_output", str(e))
        if p["verbose"] >= 1:
            print("==> Calculating initial emission probabilities")
        if p["stream_chunk"] > 0:
            # streaming builds per-chunk emissions on the fly; the
            # monolithic [S, N, 2] device e_prob would defeat the
            # out-of-HBM point of --stream_chunk
            pass
        elif distributed_run:
            # global state with the canonical mesh shardings: small
            # vectors device_put from (identical) host copies, the big
            # [S, N, *] fields computed on-device from the sharded GLs
            if site_slab is not None:
                ind_ax = "ind" if mesh_spec["ind"] > 1 else None
                stspec = dict(
                    freq=_P("site"), indF=_P(ind_ax), alpha=_P(ind_ax),
                    e_prob=_P("site", ind_ax, None),
                    p_ibd=_P("site", ind_ax), ind_lkl=_P(ind_ax),
                )
                freq_sp, ind_sp = _P("site"), _P(ind_ax)
            else:
                from .parallel.mesh import data_specs

                _, _, stspec = data_specs(False)
                freq_sp, ind_sp = _P(), _P("ind")
            out_sh = EMState(
                **{k: NamedSharding(gmesh, v) for k, v in stspec.items()}
            )
            from .parallel.driver import PAD_E_PROB, PAD_FREQ, PAD_P_IBD

            freq_h = np.asarray(freq0, np.dtype(dtype))
            if S_pad_dist != p["n_sites"]:
                freq_h = np.concatenate([
                    freq_h,
                    np.full(S_pad_dist - p["n_sites"], PAD_FREQ,
                            np.dtype(dtype)),
                ])
            freq_g = jax.device_put(freq_h, NamedSharding(gmesh, freq_sp))
            indF_g = jax.device_put(
                np.asarray(indF0, np.dtype(dtype)),
                NamedSharding(gmesh, ind_sp))
            alpha_g = jax.device_put(
                np.asarray(alpha0, np.dtype(dtype)),
                NamedSharding(gmesh, ind_sp))

            def _init(g, f, iF, al):
                st = init_state(g, f, iF, al, e_prob_calc=p["e_prob"])
                if S_pad_dist != p["n_sites"]:
                    # pad sites must enter the chain as EXACT identities
                    # (driver.PAD_* semantics): emission 1, p_ibd 0
                    padm = jnp.arange(S_pad_dist) >= p["n_sites"]
                    st = st._replace(
                        e_prob=jnp.where(
                            padm[:, None, None], PAD_E_PROB, st.e_prob),
                        p_ibd=jnp.where(padm[:, None], PAD_P_IBD, st.p_ibd),
                    )
                return st

            state = jax.jit(_init, out_shardings=out_sh)(
                gl_j, freq_g, indF_g, alpha_g
            )
        else:
            state = init_state(gl_j, jnp.asarray(freq0, dtype=dtype),
                               jnp.asarray(indF0, dtype=dtype),
                               jnp.asarray(alpha0, dtype=dtype),
                               e_prob_calc=p["e_prob"])

    # ---- EM (EM.cpp:27-135)
    if p["kernel"] not in ("scan", "blocked", "linear", "pallas"):
        error("main", f"invalid --kernel {p['kernel']!r} (scan|blocked|linear|pallas)")
    if p["opt"] not in ("speed", "compat"):
        error("main", f"invalid --opt {p['opt']!r} (speed|compat)")
    if p["gl_bf16"] not in ("0", "1", "auto"):
        error("main", f"invalid --gl_bf16 {p['gl_bf16']!r} (0|1|auto)")
    if p["gl_bf16"] == "1" and p["kernel"] != "pallas":
        error("main", "--gl_bf16 1 requires --kernel pallas (the bf16 "
                      "slabs exist only in the GL-fused tier)")
    if p["opt"] == "compat" and (
        p["kernel"] != "scan" or p["dtype"] != "float64"
        or p["n_rep"] != 1 or mesh_spec is not None
        or p["stream_chunk"] or p["checkpoint"]
    ):
        error("main", "--opt compat requires the f64 scan tier "
                      "(--kernel scan --dtype float64), a single "
                      "non-mesh non-streamed run, and no --checkpoint")
    opts = EMOptions(
        freq_est=p["freq_est"],
        e_prob_calc=p["e_prob"],
        indF_fixed=p["indF_fixed"],
        alpha_fixed=p["alpha_fixed"],
        min_iters=p["min_iters"],
        max_iters=p["max_iters"],
        min_epsilon=p["min_epsilon"],
        verbose=p["verbose"],
        block_size=None if p["kernel"] in ("scan", "pallas") else "auto",
        numerics={"linear": "linear", "pallas": "pallas"}.get(p["kernel"], "log"),
        log_every=p["log"],
        # in-HBM runs: bf16 slabs are opt-in only ("auto" keeps full
        # f32 slabs when they fit; streaming applies its own auto rule)
        gl_bf16=p["gl_bf16"] == "1",
    )
    if p["kernel"] == "pallas" and p["verbose"] >= 1:
        from .models.em import resolve_numerics

        ms = mesh_spec or {}
        streamed = p["stream_chunk"] > 0
        _, note = resolve_numerics(
            "pallas", p["freq_est"], p["e_prob"],
            replicates=(p["n_rep"] > 1 and not streamed)
            or ms.get("restart", 1) > 1,
            site_mesh=ms.get("site", 1) > 1,
            mesh_stream=streamed and (bool(ms) or distributed_run),
        )
        print(f"==> Kernel tier: {note}")

    if p["verbose"] >= 5 and freq0 is not None:
        print("==> Initial parameters:")
        for i in range(p["n_ind"]):
            print(f"\t{indF0[i]:.10f}\t{alpha0[i]:.6f}")
        print("".join(f"\t{f:.6f}" for f in freq0))

    def _geno_chunk_sites(N, S_cap):
        """~256MB of f32 GLs per gathered .geno chunk;
        NGSF_GENO_GATHER_CHUNK forces a site count (tests use it to
        cover the multi-chunk path)."""
        C = int(os.environ.get("NGSF_GENO_GATHER_CHUNK", 0)) or (
            (1 << 28) // max(1, N * 12)
        )
        return int(min(S_cap, max(1, C)))

    def _geno_chunks(freq_h, path_at):
        """Site-chunked (gl, freq, path) windows for the streamed .geno
        writer: clamp-compensated fetch_chunk windows over gl_j (a
        collective on multi-process meshes -- iterate in lockstep).
        path_at(s0, n, C) -> [n, N] path rows (host slice or device
        fetch, each with its own clamp)."""
        from .parallel.distributed import fetch_chunk

        S = p["n_sites"]
        S_gl = int(gl_j.shape[0])
        C = _geno_chunk_sites(p["n_ind"], S_gl)
        for s0 in range(0, S, C):
            n = min(C, S - s0)
            g0 = min(s0, S_gl - C)
            gl_c = fetch_chunk(gl_j, 0, g0, C)[s0 - g0:s0 - g0 + n]
            yield (gl_c.astype(np.float64), freq_h[s0:s0 + n],
                   path_at(s0, n, C))

    def write_outputs(st, tot, path_states):
        S, N = p["n_sites"], p["n_ind"]
        if path_states is None:
            path_states = np.zeros((S, N), dtype=np.int8)
        if distributed_run:
            # st is already a gathered host state (driver.adapt_state).
            # The GLs for .geno are gathered in SITE CHUNKS, not as one
            # [S, N, 3] allgather -- a full gather would put the whole
            # matrix on every host and defeat the host-sharded loading
            # design (~6 TB at the 5000 x 50M target). Every process
            # participates in each chunk's collective (lockstep);
            # process 0 streams the bytes out.
            from .io.writers import write_geno_streamed

            # st may be a lazy per-field view whose access is a
            # COLLECTIVE: touch every needed field on EVERY process
            # (lockstep), then only process 0 writes
            freq_r = np.asarray(st.freq)
            indF_r, alpha_r = np.asarray(st.indF), np.asarray(st.alpha)
            lkl_r, pibd_r = np.asarray(st.ind_lkl), np.asarray(st.p_ibd)
            chunks = _geno_chunks(
                freq_r.astype(np.float64),
                lambda s0, n, C: path_states[s0:s0 + n],
            )
            if dist_pid == 0:
                write_indF(p["out"] + ".indF", tot, indF_r, alpha_r, freq_r)
                write_ibd(p["out"] + ".ibd", lkl_r, path_states, pibd_r)
                write_geno_streamed(p["out"] + ".geno", chunks)
            else:
                for _ in chunks:  # run the collectives in lockstep
                    pass
            return
        write_indF(
            p["out"] + ".indF", tot, np.asarray(st.indF), np.asarray(st.alpha),
            np.asarray(st.freq),
        )
        write_ibd(
            p["out"] + ".ibd", np.asarray(st.ind_lkl), path_states,
            np.asarray(st.p_ibd),
        )
        write_geno(
            p["out"] + ".geno", np.asarray(gl_j, dtype=np.float64),
            np.asarray(st.freq, dtype=np.float64), path_states,
            exact_libm=p["opt"] == "compat",
        )

    def write_outputs_chunked(st, tot, path_d):
        """Final writers for mesh runs (run_em_sharded gather_final=
        False): st.e_prob/p_ibd and path_d are PADDED DEVICE arrays.
        .ibd streams ind-blocks and .geno streams site-chunks through
        distributed.fetch_chunk, so no host ever materialises an [S, N]
        matrix (the BASELINE 1000 x 10M+ configs are tens of GB per
        such matrix). Every process runs the fetches in lockstep; only
        process 0 (trivially so single-process) writes bytes."""
        from .io.writers import write_geno_streamed, write_ibd_streamed
        from .parallel.distributed import fetch_chunk

        S, N = p["n_sites"], p["n_ind"]
        S_dev = int(path_d.shape[0])  # padded site length on device
        freq_h = np.asarray(st.freq, dtype=np.float64)  # unpadded [S]

        # .ibd is per-IND rows: fetch [S_dev, B] ind-blocks
        # (NGSF_IBD_GATHER_INDS forces B; tests cover multi-block)
        B = int(os.environ.get("NGSF_IBD_GATHER_INDS", 0)) or max(
            1, (1 << 28) // max(1, S_dev * 8)
        )
        B = min(B, N)

        def _ind_blocks(arr):
            for i0 in range(0, N, B):
                i0_eff = min(i0, N - B)
                blk = fetch_chunk(arr, 1, i0_eff, B)
                off = i0 - i0_eff
                n = min(B, N - i0)
                yield blk[:S, off:off + n]

        def _path_at(s0, n, C):
            p0 = min(s0, S_dev - C)
            return fetch_chunk(path_d, 0, p0, C)[s0 - p0:s0 - p0 + n]

        chunks = _geno_chunks(freq_h, _path_at)

        if dist_pid == 0:
            # freq at its native dtype for .indF (%f text must match the
            # ungathered writers byte for byte), float64 for .geno
            write_indF(p["out"] + ".indF", tot, np.asarray(st.indF),
                       np.asarray(st.alpha), np.asarray(st.freq))
            write_ibd_streamed(p["out"] + ".ibd", np.asarray(st.ind_lkl),
                               _ind_blocks(path_d), _ind_blocks(st.p_ibd))
            write_geno_streamed(p["out"] + ".geno", chunks)
        else:
            # keep the collectives in lockstep with process 0's writers
            for it in (_ind_blocks(path_d), _ind_blocks(st.p_ibd), chunks):
                for _ in it:
                    pass

    def log_cb(n_iter, st, tot):
        if light_resume and n_iter <= int(resume_bk["n_iter"]):
            # params-only resume: p_ibd/ind_lkl are placeholders until
            # the first resumed iteration completes, and the --log
            # rewrite fires at the TOP of the loop (EM.cpp:59-63) --
            # logging at the resume point would write zeros
            return
        if p["log"] and (n_iter == 1 or n_iter % p["log"] == 0):
            if p["verbose"] >= 1:
                print("==> Printing current iteration parameters")
            write_outputs(st, tot, None)

    def trace(event, **kw):
        v = p["verbose"]
        if v < 1:
            return
        if event == "iter_start":
            print(f"\nIteration {kw['n_iter']}:")
            print("==> Forward Recursion")
            print("==> Backward Recursion")
            print("==> Marginal probabilities")
            if p["indF_fixed"] and p["alpha_fixed"]:
                print("==> Inbreeding and transition parameter not estimated!")
            else:
                print("==> Update inbreeding and transition parameter")
            if p["freq_est"] == 0:
                print("==> Alelle frequencies not estimated!")
            else:
                print(
                    "==> Estimating allele frequencies and calculating "
                    "emission probabilities"
                )
        elif event == "iter_done":
            if v >= 4:
                st = kw["state"]
                # streaming mode carries (freq, indF, alpha, ll) tuples
                indF_a, alpha_a = (
                    (st.indF, st.alpha) if hasattr(st, "indF")
                    else (st[1], st[2])
                )
                for i in range(p["n_ind"]):
                    print(f"\t{float(indF_a[i]):.10f}\t{float(alpha_a[i]):.6f}")
            if v >= 7 and p["freq_est"] != 0 and hasattr(kw["state"], "e_prob"):
                # per-site freq/emission dump (EM.cpp:265-270); printed
                # once per iteration from the updated state (the
                # reference prints during its per-site freq loop)
                st = kw["state"]
                freq = np.asarray(st.freq, dtype=np.float64)
                em = np.exp(np.asarray(st.e_prob, dtype=np.float64))
                for s in range(p["n_sites"]):
                    row = "".join(
                        f"\t{em[s, i, 0]:f}/{em[s, i, 1]:f}"
                        for i in range(p["n_ind"])
                    )
                    print(f"Site {s + 1}; freq: {freq[s]:f}; emission: {row}")
            if v >= 3:
                # per-phase timer block (EM.cpp:277-284). The iteration
                # is one fused XLA computation here, so the whole step's
                # wall time is reported on the Fw line and the other
                # phases as 0.0 (documented delta; cli.py header notes)
                print(
                    f"\nFw: {kw['dt']:.1f}\nBw: 0.0\nMP: 0.0\n"
                    "indF: 0.0\nfreqs: 0.0"
                )
            print(
                f"\tLogLkl: {kw['tot_lkl']:.15f}\t max lkl epsilon: "
                f"{kw['max_eps']:.15f}\ttime: {kw['dt']:.0f} (s)"
            )
            if v >= 3:
                for i in range(p["n_ind"]):
                    tag = " (max)" if i == kw["imax"] else ""
                    print(
                        f"\tInd {i + 1}: {kw['ind_lkl'][i]:.15f}\t "
                        f"lkl epsilon: {kw['ind_eps'][i]:.15f}{tag}"
                    )
            sys.stdout.flush()

    ckpt_cb = None
    resume_bk = None
    if p["resume"] and not p["checkpoint"]:
        error("main", "--resume requires --checkpoint FILE")
    if p["checkpoint"] and p["checkpoint_every"] < 1:
        error("main", "--checkpoint_every must be >= 1")
    def _rebuild_from_params(freq_ck, indF_ck, alpha_ck):
        """EM state from a params-only checkpoint: emissions rebuilt with
        the IN-LOOP recompute form (what the next iteration's E-step
        reads -- em.py's fast/log branch, site_sharded.py:254-265),
        p_ibd/ind_lkl zeroed (both write-only before first use)."""
        from .models.em import in_loop_emission_form
        from .ops.emissions import calc_emission, emission_probs_linear

        fast_form = "linear" == in_loop_emission_form(
            p["freq_est"],
            {"linear": "linear", "pallas": "pallas"}.get(
                p["kernel"], "log"),
            site_sharded=mesh_spec is not None and mesh_spec["site"] > 1,
        )

        def _mk(g, f, iF, al):
            if fast_form:
                e = jnp.log(emission_probs_linear(jnp.exp(g), f[:, None]))
            else:
                e = calc_emission(g, f[:, None])
            S_g = g.shape[0]
            if S_g != p["n_sites"]:
                from .parallel.driver import PAD_E_PROB

                padm = jnp.arange(S_g) >= p["n_sites"]
                e = jnp.where(padm[:, None, None], PAD_E_PROB, e)
            return EMState(
                freq=f, indF=iF, alpha=al, e_prob=e,
                p_ibd=jnp.zeros((S_g, g.shape[1]), g.dtype),
                ind_lkl=jnp.zeros((g.shape[1],), g.dtype),
            )

        _f = np.dtype(dtype)
        f_np = np.asarray(freq_ck, _f)
        if distributed_run:
            from .parallel.driver import PAD_FREQ

            if S_pad_dist != p["n_sites"]:
                f_np = np.concatenate([
                    f_np,
                    np.full(S_pad_dist - p["n_sites"], PAD_FREQ, _f),
                ])
            f_g = jax.device_put(f_np, NamedSharding(gmesh, freq_sp))
            iF_g = jax.device_put(np.asarray(indF_ck, _f),
                                  NamedSharding(gmesh, ind_sp))
            al_g = jax.device_put(np.asarray(alpha_ck, _f),
                                  NamedSharding(gmesh, ind_sp))
            return jax.jit(_mk, out_shardings=out_sh)(gl_j, f_g, iF_g, al_g)
        return _mk(gl_j, jnp.asarray(f_np), jnp.asarray(indF_ck, _f),
                   jnp.asarray(alpha_ck, _f))

    light_resume = False
    # mesh runs checkpoint (freq, indF, alpha) ONLY: with e_prob_calc 1
    # (all meshes; the LD path is rejected up front) emissions are the
    # in-loop function of (gl, freq), p_ibd is write-only within an
    # iteration and ind_lkl is overwritten by the first resumed step --
    # a full-state save would be O(S*N) (~160 GB at 1000 x 10M)
    light_ckpt = mesh_spec is not None and p["n_rep"] == 1
    if p["checkpoint"] and not p["stream_chunk"]:
        from .io.checkpoint import (
            checkpoint_format,
            load_checkpoint,
            load_params_checkpoint,
            save_checkpoint,
            save_params_checkpoint,
        )

        if p["resume"]:
            try:
                ck_fmt = checkpoint_format(p["checkpoint"])
                if ck_fmt == "params":
                    (ck_freq, ck_indF, ck_alpha), resume_bk = \
                        load_params_checkpoint(p["checkpoint"])
                else:
                    ck_state, resume_bk = load_checkpoint(p["checkpoint"])
            except FileNotFoundError:
                error("main", f'checkpoint file "{p["checkpoint"]}" not found')
            except ValueError as e:
                error("main", str(e))
            if ck_fmt == "params":
                if p["n_rep"] > 1:
                    error("main", "params-only checkpoints carry a single "
                                  "run, not --n_rep replicates")
                if p["e_prob"] == 2:
                    error("main", "params-only checkpoints cannot rebuild "
                                  "the frozen LD init emissions (--e_prob "
                                  "2); use a full checkpoint")
                if ck_freq.shape != (p["n_sites"],) or \
                        ck_indF.shape != (p["n_ind"],):
                    error(
                        "main",
                        "checkpoint shape mismatch: has "
                        f"freq{ck_freq.shape} indF{ck_indF.shape}, run "
                        f"wants freq({p['n_sites']},) indF({p['n_ind']},)",
                    )
                state = _rebuild_from_params(ck_freq, ck_indF, ck_alpha)
                light_resume = True
                if p["verbose"] >= 1:
                    print(
                        f'==> Resuming from "{p["checkpoint"]}" at '
                        f"iteration {int(resume_bk['n_iter'])} "
                        "(params-only checkpoint; emissions rebuilt)"
                    )
            if ck_fmt == "full":
                ck_rep = int(resume_bk.get("n_rep", 1))
                if ck_rep != p["n_rep"]:
                    error(
                        "main",
                        f"checkpoint has {ck_rep} replicate(s), "
                        f"run has --n_rep {p['n_rep']}",
                    )
                # multi-restart states carry a leading [R] axis
                want = ((p["n_rep"], p["n_sites"]),
                        (p["n_rep"], p["n_ind"])) \
                    if p["n_rep"] > 1 else ((p["n_sites"],), (p["n_ind"],))
                if ck_state.freq.shape != want[0] or \
                        ck_state.indF.shape != want[1]:
                    error(
                        "main",
                        "checkpoint shape mismatch: has "
                        f"freq{ck_state.freq.shape} "
                        f"indF{ck_state.indF.shape}, run wants "
                        f"freq{want[0]} indF{want[1]}",
                    )
            if ck_fmt == "full" and p["n_rep"] == 1:
                state = ck_state
                if distributed_run:
                    # checkpoints store the gathered UNPADDED host state;
                    # a distributed run needs it back on the global mesh
                    # (site meshes: re-padded with exact-identity sites)
                    pad = S_pad_dist - p["n_sites"]
                    if pad:
                        from .parallel.driver import (
                            PAD_E_PROB,
                            PAD_FREQ,
                            PAD_P_IBD,
                        )

                        _f = np.dtype(dtype)

                        def _padc(x, value, width):
                            x = np.asarray(x, _f)
                            shape = (width,) + x.shape[1:]
                            return np.concatenate(
                                [x, np.full(shape, value, _f)]
                            )

                        state = state._replace(
                            freq=_padc(state.freq, PAD_FREQ, pad),
                            e_prob=_padc(state.e_prob, PAD_E_PROB, pad),
                            p_ibd=_padc(state.p_ibd, PAD_P_IBD, pad),
                        )
                    state = EMState(
                        *(np.asarray(x, np.dtype(dtype)) for x in state)
                    )
                    state = jax.device_put(state, out_sh)
            if ck_fmt == "full" and p["verbose"] >= 1:
                print(
                    f'==> Resuming from "{p["checkpoint"]}" at iteration '
                    f"{int(resume_bk['n_iter'])}"
                )

        def ckpt_cb(n_iter, st, bk):
            # distributed runs: st arrives as a lazily-gathered view
            # (driver._HostStateView) whose field access is a COLLECTIVE
            # -- touch the needed fields on EVERY process (lockstep),
            # then only process 0 writes. Mesh runs save params-only
            # (just freq/indF/alpha -- never the [S, N]-sized fields).
            if n_iter % p["checkpoint_every"] != 0:
                return
            if light_ckpt:
                f, iF, al = st.freq, st.indF, st.alpha
                if not distributed_run or dist_pid == 0:
                    save_params_checkpoint(
                        p["checkpoint"], f, iF, al, {**bk, "n_rep": 1}
                    )
            else:
                st_h = EMState(
                    *(np.asarray(getattr(st, f)) for f in EMState._fields)
                )
                if not distributed_run or dist_pid == 0:
                    save_checkpoint(
                        p["checkpoint"], st_h, {**bk, "n_rep": p["n_rep"]}
                    )


    if mesh_spec is not None and p["verbose"] >= 1:
        n_need = (
            mesh_spec["restart"] * mesh_spec["ind"] * mesh_spec["site"]
        )
        procs = f" across {p['n_procs']} processes" if distributed_run else ""
        print(
            f"==> Mesh run: restart={mesh_spec['restart']} x "
            f"ind={mesh_spec['ind']} x site={mesh_spec['site']} "
            f"({n_need} of {len(jax.devices())} devices{procs})"
        )

    from .utils.signals import catch_sig

    catch_sig()  # graceful SIGINT/SIGTERM stop (gen_func.cpp:40-52)

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if p["profile"]:
        import jax.profiler

        profile_ctx = jax.profiler.trace(p["profile"])
        if p["verbose"] >= 1:
            print(f'==> Profiling EM loop to "{p["profile"]}"')

    if p["stream_chunk"] > 0:
        # ---- streaming EM: out-of-HBM path (models/streaming.py);
        # --n_rep > 1 runs the .sh protocol as sequential restarts below
        # (checkpoint + stream restarts rejected at validation time)
        # (the LD path is rejected at arg-parse time)
        from .io.writers import write_geno_streamed
        from .models.streaming import StreamingEM, streaming_viterbi

        stream_mesh = None
        if distributed_run:
            # the GLOBAL (1, ind) mesh built for per-host slab loading;
            # each process streams its ind columns, chunk kernels run on
            # globally-assembled arrays (est_maf psums ride DCN)
            stream_mesh = gmesh
        elif mesh_spec is not None:
            from .parallel.mesh import make_mesh

            n_need = mesh_spec["ind"]
            if n_need > len(jax.devices()):
                error("main", f"mesh needs {n_need} devices, have "
                              f"{len(jax.devices())}")
            stream_mesh = make_mesh(
                1, n_need, devices=jax.devices()[:n_need]
            )
        if p["verbose"] >= 1:
            extra = (
                f", ind sharded {mesh_spec['ind']}-way"
                if stream_mesh is not None else ""
            )
            if distributed_run:
                extra += f" across {p['n_procs']} processes"
            print(f"==> Streaming EM ({p['stream_chunk']} sites/chunk"
                  f"{extra})")
        # the PROCESSED likelihoods (post --call_geno + renormalisation),
        # exactly what the monolithic path trains on. With --stream_file
        # the source IS the processed view, read per chunk from disk
        # (multi-host: just this process's ind columns).
        gl_host = gl_j if gl_src is not None else np.asarray(gl_j,
                                                             np.float64)
        try:
            se = StreamingEM(
                gl_host, dist, chunk_sites=p["stream_chunk"],
                mesh=stream_mesh,
                n_ind_total=p["n_ind"] if distributed_run else None,
                slab_bf16={"0": False, "1": True}.get(
                    p["gl_bf16"], "auto"),
            )
        except ValueError as e:  # e.g. n_ind not divisible by mesh axis
            error("EM", str(e))
        S_, N_ = gl_host.shape[0], gl_host.shape[1]
        _pibd_mm = _path_mm = None
        if gl_src is not None:
            # [S, N] accumulators spill to disk-backed memmaps: at the
            # 5000 x 50M config they are ~1 TB (f32) + 250 GB (int8).
            # Stored IND-MAJOR ([N, S]) so the per-individual .ibd rows
            # read back contiguously; the engine writes site-chunk rows
            # through the transposed view (N strided runs per chunk).
            # No pre-zeroing: a fresh "w+" memmap already reads as zeros
            # (sparse), and the single post-convergence posterior pass
            # writes every row exactly once.
            _pibd_mm = np.memmap(os.path.join(_spill.name, "p_ibd.f32"),
                                 np.float32, "w+", shape=(N_, S_))
            p_ibd = _pibd_mm.T
        else:
            p_ibd = np.zeros((S_, N_), np.float32)

        stream_ckpt_cb = None
        stream_resume_bk = None
        if p["checkpoint"]:
            from .io.checkpoint import (
                load_stream_checkpoint,
                save_stream_checkpoint,
            )

            if p["resume"]:
                try:
                    (freq0, indF0, alpha0), stream_resume_bk = \
                        load_stream_checkpoint(p["checkpoint"])
                except FileNotFoundError:
                    error("main",
                          f'checkpoint file "{p["checkpoint"]}" not found')
                except ValueError as e:
                    error("main", str(e))
                # checkpoints hold the GLOBAL parameter vectors
                if freq0.shape != (p["n_sites"],) or \
                        indF0.shape != (p["n_ind"],):
                    error(
                        "main",
                        f"checkpoint shape mismatch: has freq{freq0.shape} "
                        f"indF{indF0.shape}, run wants "
                        f"freq({p['n_sites']},) indF({p['n_ind']},)",
                    )
                if p["verbose"] >= 1:
                    print(
                        f'==> Resuming from "{p["checkpoint"]}" at iteration '
                        f"{int(stream_resume_bk['n_iter'])}"
                    )

            def stream_ckpt_cb(n_iter, params, bk):
                # params arrive gathered (StreamingEM.run); only one
                # process touches disk
                if n_iter % p["checkpoint_every"] == 0 and (
                    not distributed_run or dist_pid == 0
                ):
                    save_stream_checkpoint(p["checkpoint"], *params, bk)

        # multi-host: this process optimises only its ind block (the
        # single-process slice is the whole vector)
        i0_loc = ind_slab[0] if distributed_run else 0
        try:
            with profile_ctx:
                if p["n_rep"] > 1:
                    # ---- sequential restarts through ONE streaming
                    # engine (the ngsF-HMM.sh protocol, ngsF-HMM.sh:
                    # 83-99: independent full runs, keep the best total
                    # lkl). Replicate r re-resolves RANDOM inits with
                    # GslTaus(seed + r), matching the lockstep protocol
                    # (models/restart.stack_restart_states); compiled
                    # chunk kernels are shared across replicates. The
                    # final posterior pass runs only for the winner.
                    from .io.gsl_rng import GslTaus as _Taus
                    from .io.init import init_freq as _init_freq
                    from .io.init import init_indF_alpha as _init_ia

                    best = None
                    rep_summary = []
                    for r_i in range(p["n_rep"]):
                        rng_r = _Taus(p["seed"] + r_i)
                        iF_r, al_r = _init_ia(
                            p["indF"], p["n_ind"], rng_r
                        )
                        fq_r = (
                            _init_freq("r", p["n_sites"], rng_r)
                            if fspec == "r" else freq0
                        )
                        if p["verbose"] >= 1:
                            print(f"\n==> Replicate {r_i + 1} of "
                                  f"{p['n_rep']}")
                        fqf, Ff, af, ll, ni = se.run(
                            fq_r,
                            np.asarray(iF_r, np.float64)[
                                i0_loc:i0_loc + N_],
                            np.asarray(al_r, np.float64)[
                                i0_loc:i0_loc + N_],
                            opts, trace=trace,
                        )
                        tot_r = float(se._gather_ind(ll).sum())
                        rep_summary.append((tot_r, ni))
                        if best is None or tot_r > best[0]:
                            best = (tot_r, fqf, Ff, af, ll, ni,
                                    se._last_prev_params)
                    _, freq_f, F_f, a_f, ind_lkl, n_iters, prev_b = best
                    if p["verbose"] >= 1:
                        bi = int(np.argmax(
                            [t for t, _ in rep_summary]
                        ))
                        for r_i, (lk, it) in enumerate(rep_summary):
                            tag = "  <== best" if r_i == bi else ""
                            print(f"Replicate {r_i + 1}: logLkl "
                                  f"{lk:.6f} ({it} iters){tag}")
                    se.posteriors_pass(*prev_b, p_ibd)
                else:
                    indF_run = np.asarray(indF0, np.float64)[
                        i0_loc:i0_loc + N_]
                    alpha_run = np.asarray(alpha0, np.float64)[
                        i0_loc:i0_loc + N_]
                    freq_f, F_f, a_f, ind_lkl, n_iters = se.run(
                        freq0, indF_run, alpha_run, opts, p_ibd_out=p_ibd,
                        checkpoint_cb=stream_ckpt_cb,
                        resume_bookkeeping=stream_resume_bk, trace=trace,
                    )
        except (NotImplementedError, ValueError) as e:
            error("EM", str(e))
        # global per-ind views for the gate warning, prints and writers
        # (gathers are lockstep collectives on every process)
        ll_all = se._gather_ind(ind_lkl)
        F_all = se._gather_ind(F_f)
        a_all = se._gather_ind(a_f)
        if n_iters >= p["max_iters"]:
            print(
                "WARN: Maximum number of iterations reached! Check if "
                "analysis converged... "
            )
        if p["verbose"] >= 1:
            print("\n==> Decoding most probable path (Viterbi)")
            print(f"Final logLkl: {ll_all.sum():.6f}")
            print("Printing final results")
        path_out = None
        if gl_src is not None:
            _path_mm = np.memmap(os.path.join(_spill.name, "path.i8"),
                                 np.int8, "w+", shape=(N_, S_))
            path_out = _path_mm.T
        path = streaming_viterbi(se, freq_f, F_f, a_f, path_out=path_out)
        if not distributed_run or dist_pid == 0:
            write_indF(p["out"] + ".indF", float(ll_all.sum()),
                       F_all, a_all, freq_f)

        def _ind_row_blocks(mm):
            # sized by the FORMATTED footprint: np.char.mod produces a
            # UCS4 array at ~32 B/value, ~8x the raw f32 block
            Bw = max(1, (1 << 30) // max(1, S_ * 32))
            for i0 in range(0, mm.shape[0], Bw):
                yield np.asarray(mm[i0:i0 + Bw]).T  # [S, b]

        if distributed_run:
            # each process holds only its ind columns: write per-process
            # .ibd row part-files (shared filesystem, like every other
            # output), barrier, process 0 stitches them in ind order
            from jax.experimental import multihost_utils

            from .io.writers import (
                write_ibd_header,
                write_path_rows,
                write_post_rows,
            )

            part = f'{p["out"]}.ibd.part{dist_pid}'
            with open(part + ".path", "w") as fh:
                write_path_rows(fh, _ind_row_blocks(_path_mm))
            with open(part + ".post", "w") as fh:
                write_post_rows(fh, _ind_row_blocks(_pibd_mm))
            multihost_utils.sync_global_devices("ngsf_ibd_parts")
            if dist_pid == 0:
                import shutil

                with open(p["out"] + ".ibd", "w") as fh:
                    write_ibd_header(fh, ll_all)
                    for ext in (".path", ".post"):
                        for q in range(p["n_procs"]):
                            with open(f'{p["out"]}.ibd.part{q}{ext}') as sf:
                                shutil.copyfileobj(sf, fh)
            multihost_utils.sync_global_devices("ngsf_ibd_done")
            for ext in (".path", ".post"):
                os.unlink(part + ext)
        elif gl_src is not None:
            # stream the .ibd rows from the ind-major spill files (one
            # contiguous read per ind-block) -- write_ibd would
            # materialise the [S, N] matrices whole
            from .io.writers import write_ibd_streamed

            write_ibd_streamed(p["out"] + ".ibd", ind_lkl,
                               _ind_row_blocks(_path_mm),
                               _ind_row_blocks(_pibd_mm))
        else:
            write_ibd(p["out"] + ".ibd", ind_lkl, path, p_ibd)

        if distributed_run:
            # .geno is site-major (all inds interleave per site): gather
            # each site chunk's gl/path globally (lockstep collectives),
            # process 0 computes the posteriors and writes
            _gsh = NamedSharding(gmesh, _P(None, "ind", None))
            _psh = NamedSharding(gmesh, _P(None, "ind"))

            def _stream_geno_chunks():
                for c in range(se.C):
                    lo = c * se.cs
                    hi = min(lo + se.cs, S_)
                    gl_g = dist_mod.host_array(dist_mod.global_from_slab(
                        _gsh, np.asarray(gl_host[lo:hi], np.float64),
                        (hi - lo, p["n_ind"], 3)))
                    pa_g = dist_mod.host_array(dist_mod.global_from_slab(
                        _psh, np.ascontiguousarray(path[lo:hi]),
                        (hi - lo, p["n_ind"])))
                    yield (gl_g.astype(np.float64),
                           freq_f[lo:hi].astype(np.float64), pa_g)

            if dist_pid == 0:
                write_geno_streamed(p["out"] + ".geno",
                                    _stream_geno_chunks())
            else:
                for _ in _stream_geno_chunks():
                    pass
        else:
            def _stream_geno_chunks():
                for c in range(se.C):
                    lo = c * se.cs
                    hi = min(lo + se.cs, S_)
                    yield (
                        np.asarray(gl_host[lo:hi], np.float64),
                        freq_f[lo:hi].astype(np.float64),
                        np.asarray(path[lo:hi]),
                    )

            write_geno_streamed(p["out"] + ".geno", _stream_geno_chunks())
        if p["verbose"] >= 1:
            print("Freeing memory...")
            print("Done!")
        return 0

    if p["n_rep"] > 1:
        # ngsF-HMM.sh multi-restart protocol as a vmapped axis: replicate
        # r resolves its random inits with seed+r; best total lkl wins.
        from .models.restart import run_em_restarts, stack_restart_states

        if resume_bk is not None:
            states_r = ck_state  # stacked [R] state from the checkpoint
        else:
            states_r = stack_restart_states(
                gl_j, p["n_rep"], p["seed"], indF_spec=p["indF"],
                freq_spec=p["freq"], freq_est=p["freq_est"],
                e_prob_calc=p["e_prob"],
            )

        def multi_trace(event, **kw):
            # lockstep-replicate analog of the single-run trace: the
            # .sh protocol runs N sequential full runs, each with its
            # own stdout; here one fused iteration advances all
            # replicates, so the per-iteration lines report the current
            # best replicate (v >= 3 adds the per-replicate table)
            v = p["verbose"]
            if v < 1:
                return
            if event == "iter_start":
                trace(event, **kw)
                return
            if event != "iter_done":
                return
            tots = np.asarray(kw["tot_lkl"], np.float64)
            eps = np.asarray(kw["max_eps"], np.float64)
            best = int(np.argmax(tots))
            print(
                f"\tLogLkl (best replicate {best + 1}): {tots[best]:.15f}"
                f"\t max lkl epsilon: {eps[best]:.15f}"
                f"\ttime: {kw['dt']:.0f} (s)"
            )
            if v >= 3:
                active = kw.get("active")
                for r in range(len(tots)):
                    tag = " (best)" if r == best else ""
                    if active is not None and not active[r]:
                        tag += " [converged]"
                    print(
                        f"\tReplicate {r + 1}: {tots[r]:.15f}\t "
                        f"lkl epsilon: {eps[r]:.15f}{tag}"
                    )
            sys.stdout.flush()

        def multi_log_cb(n_iter, states, tots):
            # --log N in multi-restart mode dumps the CURRENT BEST
            # replicate's state (the .sh protocol has no equivalent; the
            # single-run semantics, EM.cpp:59-63, apply to the leader)
            if p["log"] and n_iter > 0 and (n_iter == 1 or n_iter % p["log"] == 0):
                import jax as _jax

                best = int(np.argmax(tots))
                st_b = _jax.tree.map(lambda x: x[best], states)
                if p["verbose"] >= 1:
                    print("==> Printing current iteration parameters "
                          f"(best replicate {best + 1})")
                write_outputs(st_b, float(tots[best]), None)

        with profile_ctx:
            try:
                if mesh_spec is not None:
                    from .parallel.driver import run_em_sharded

                    rres = run_em_sharded(
                        gl_j, dist_j, states_r, opts, mesh_spec,
                        log_callback=multi_log_cb, trace=multi_trace,
                        checkpoint_cb=ckpt_cb,
                        resume_bookkeeping=resume_bk,
                    )
                else:
                    rres = run_em_restarts(
                        gl_j, dist_j, states_r, opts,
                        log_callback=multi_log_cb, trace=multi_trace,
                        checkpoint_cb=ckpt_cb, resume_bookkeeping=resume_bk,
                    )
            except (RuntimeError, ValueError, NotImplementedError) as e:
                error("EM", str(e))
        if p["verbose"] >= 1:
            for r, (lk, it) in enumerate(zip(rres.rep_lkl, rres.rep_iters)):
                tag = "  <== best" if r == rres.best_rep else ""
                print(f"Replicate {r + 1}: logLkl {lk:.6f} ({it} iters){tag}")
        result = rres.best
    else:
        with profile_ctx:
            try:
                if mesh_spec is not None:
                    from .parallel.driver import run_em_sharded

                    result = run_em_sharded(
                        gl_j, dist_j, state, opts, mesh_spec,
                        log_callback=log_cb, trace=trace,
                        checkpoint_cb=ckpt_cb,
                        resume_bookkeeping=resume_bk,
                        S_true=p["n_sites"] if distributed_run else None,
                        gather_final=False,  # chunked final writers
                    )
                elif p["opt"] == "compat":
                    from .models.em_compat import run_em_compat

                    result = run_em_compat(
                        gl_j, dist_j, state, opts,
                        log_callback=log_cb, trace=trace,
                    )
                else:
                    result = run_em(
                        gl_j, dist_j, state, opts, log_callback=log_cb,
                        trace=trace, checkpoint_cb=ckpt_cb,
                        resume_bookkeeping=resume_bk,
                    )
            except (RuntimeError, ValueError, NotImplementedError) as e:
                error("EM", str(e))

    if light_resume and result.n_iters <= int(resume_bk["n_iter"]):
        # params-only checkpoints zero p_ibd/ind_lkl (rebuilt by the
        # first resumed iteration); a resume that runs NO iterations
        # would write those zeros into .ibd/.indF
        error(
            "main",
            "checkpoint is already terminal under these options (no "
            "iterations ran on resume); the original run wrote the "
            "final outputs -- raise --max_iters / lower --min_epsilon "
            "to continue training",
        )
    if not result.converged:
        print(
            "WARN: Maximum number of iterations reached! Check if analysis "
            "converged... "
        )
    if p["verbose"] >= 1:
        print("\n==> Decoding most probable path (Viterbi)")
        print(f"Final logLkl: {result.tot_lkl:.6f}")
        print("Printing final results")
    if mesh_spec is not None and p["n_rep"] == 1:
        # gather_final=False run: device-resident results, chunked write
        write_outputs_chunked(result.state, result.tot_lkl, result.path)
    else:
        write_outputs(result.state, result.tot_lkl, result.path)

    if p["verbose"] >= 1:
        print("Freeing memory...")
        print("Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
