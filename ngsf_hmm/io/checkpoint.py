"""Checkpoint/resume for EM runs.

The reference has no formal checkpointing: ``--log N`` rewrites the
output set every N iterations (reference: EM.cpp:59-63) and runs can be
warm-started from those outputs via ``--indF FILE`` / ``--freq FILE``
(parse_args.cpp:255-276,326-355) -- both of which this engine also
supports. This module adds what the reference lacks: an exact-resume
checkpoint carrying the full EM state (including emissions, which are
NOT derivable from freq under the frozen-emission modes, SURVEY.md
S3.6e) plus the convergence bookkeeping of the host loop, so a resumed
run continues bit-for-bit where it stopped.

Format: a single .npz with the EMState arrays and a JSON metadata blob
(iteration counter, per-individual likelihood history, engine/version
info). Atomic write via rename.
"""

import json
import os
import tempfile

import numpy as np
import jax.numpy as jnp

from ..utils.constants import VERSION
from ..models.em import EMState

FORMAT = "ngsf-hmm-ckpt-v1"
STREAM_FORMAT = "ngsf-hmm-stream-ckpt-v1"


_OPT_MEM_KEYS = ("opt_S", "opt_Y", "opt_valid", "opt_head")


def _atomic_savez(path, fmt, arrays, bookkeeping):
    # The warm-started M-step's L-BFGS curvature memory rides the
    # bookkeeping dict under "opt_mem" (models/em.run_em) -- O(m * N)
    # arrays, stored as npz fields so resume reproduces the
    # uninterrupted trajectory exactly. Checkpoints without it (older
    # files, cold-start modes) resume with a cold-started optimizer.
    opt_mem = bookkeeping.get("opt_mem")
    if opt_mem is not None:
        bookkeeping = {k: v for k, v in bookkeeping.items()
                       if k != "opt_mem"}
        arrays = dict(arrays)
        for k, v in zip(_OPT_MEM_KEYS, opt_mem):
            arrays[k] = np.asarray(v)
    meta = {
        "format": fmt,
        "version": VERSION,
        "bookkeeping": {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in bookkeeping.items()
        },
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(path, state: EMState, bookkeeping: dict):
    """Write state + host-loop bookkeeping atomically to ``path`` (.npz)."""
    arrays = {f: np.asarray(getattr(state, f)) for f in EMState._fields}
    _atomic_savez(path, FORMAT, arrays, bookkeeping)


def _load_npz(path, fmt, field_names, dtype=None, as_jax=True):
    try:
        z = np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:  # BadZipFile, np's own ValueError, ...
        raise ValueError(f"{path}: not a readable {fmt} checkpoint ({e})")
    try:
        with z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            if meta.get("format") != fmt:
                raise ValueError(
                    f"{path}: not a {fmt} checkpoint "
                    f"(got {meta.get('format')!r})"
                )
            fields = {}
            for f in field_names:
                a = z[f]
                if dtype is not None:
                    a = a.astype(dtype)
                fields[f] = jnp.asarray(a) if as_jax else a
            opt_mem = None
            if all(k in z.files for k in _OPT_MEM_KEYS):
                opt_mem = tuple(z[k] for k in _OPT_MEM_KEYS)
    except ValueError:
        raise
    except Exception as e:  # KeyError, json/pickle errors, ...
        raise ValueError(f"{path}: not a readable {fmt} checkpoint ({e})")
    bk = meta["bookkeeping"]
    # restore array-valued bookkeeping (scalars in single-run checkpoints,
    # [R]-shaped in multi-restart ones -- lists after the JSON round-trip)
    for k in ("prev_ind", "prev_tot", "tot", "max_eps", "active",
              "iters_done"):
        if k in bk and isinstance(bk[k], list):
            bk[k] = np.asarray(bk[k])
    # optional L-BFGS warm-start memory (see _atomic_savez)
    if opt_mem is not None:
        bk["opt_mem"] = opt_mem
    return fields, bk


def load_checkpoint(path, dtype=None):
    """Read (EMState, bookkeeping dict) from ``path``.

    dtype: optionally cast arrays (e.g. resume an f64 checkpoint in f32
    speed mode).
    """
    fields, bk = _load_npz(path, FORMAT, EMState._fields, dtype=dtype)
    return EMState(**fields), bk


_STREAM_FIELDS = ("freq", "indF", "alpha")


def save_stream_checkpoint(path, freq, indF, alpha, bookkeeping: dict):
    """Streaming-EM checkpoint: (freq, indF, alpha) + bookkeeping.

    Emissions are a function of freq in the streaming engine (never
    materialised whole), so this tiny state is sufficient for an exact
    resume of models/streaming.StreamingEM.run."""
    arrays = {
        "freq": np.asarray(freq),
        "indF": np.asarray(indF),
        "alpha": np.asarray(alpha),
    }
    _atomic_savez(path, STREAM_FORMAT, arrays, bookkeeping)


def load_stream_checkpoint(path):
    """Read ((freq, indF, alpha) as float64 numpy, bookkeeping dict)."""
    fields, bk = _load_npz(
        path, STREAM_FORMAT, _STREAM_FIELDS, dtype=np.float64, as_jax=False
    )
    return (fields["freq"], fields["indF"], fields["alpha"]), bk


# Params-only checkpoints for MESH runs reuse the streaming schema: with
# e_prob_calc == 1 (the whole mesh-supported envelope) the emissions are
# a pure function of (gl, freq) -- the in-loop recompute form -- p_ibd
# is write-only inside an iteration, and ind_lkl is overwritten by the
# first resumed step, so (freq, indF, alpha) + bookkeeping is an exact
# resume. This keeps checkpoints O(S + N) instead of O(S * N): at the
# 1000 x 10M BASELINE config the full-state schema is ~160 GB per save.
save_params_checkpoint = save_stream_checkpoint
load_params_checkpoint = load_stream_checkpoint


def checkpoint_format(path):
    """The format tag of a checkpoint file ('full' | 'params'), without
    loading the arrays -- lets a resume accept either schema."""
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
    except FileNotFoundError:
        raise
    except Exception as e:
        raise ValueError(f"{path}: not a readable checkpoint ({e})")
    fmt = meta.get("format")
    if fmt == FORMAT:
        return "full"
    if fmt == STREAM_FORMAT:
        return "params"
    raise ValueError(f"{path}: unknown checkpoint format {fmt!r}")
