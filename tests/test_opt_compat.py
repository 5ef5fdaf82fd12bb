"""RefLBFGSB (models/lbfgsb_ref.py) vs the reference's findmax_bfgs.

Compiles a tiny C probe around /root/reference/shared/bfgs.cpp that runs
findmax_bfgs on deterministic 2-parameter objectives built ONLY from
IEEE-exact operations (+,-,*,/,sqrt -- no libm transcendentals, whose
last-ulp behaviour differs between glibc and numpy), logging every
objective evaluation and the final point as hex floats. The Python
implementation must request the SAME evaluation sequence bit-for-bit
and land the SAME endpoint -- that is the property that upgrades
estimated-config golden outputs to byte parity (--opt compat).
"""

import math
import pathlib
import struct
import subprocess

import numpy as np
import pytest

from ngsf_hmm.models.lbfgsb_ref import RefLBFGSB

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_SRC = pathlib.Path("/root/reference")

PROBE_C = r"""
#include <stdio.h>
#include <math.h>
#include "bfgs.h"

static int which;

double obj(const double x[], const void *dats) {
  (void)dats;
  double a = x[0], b = x[1];
  double f;
  switch (which) {
  case 0:  /* shifted Rosenbrock + sqrt term; interior optimum */
    f = 100.0*(b - a*a)*(b - a*a) + (1.0-a)*(1.0-a) + sqrt(a + 2.0);
    break;
  case 1:  /* optimum pressed into both bounds */
    f = (a - 2.0)*(a - 2.0) + 0.01/(b + 0.1) + 3.0*b;
    break;
  case 2:  /* ill-scaled valley, likelihood-like magnitudes */
    f = 1.0e4*(a - 0.3)*(a - 0.3)*(1.0 + 5.0*b)
        + 700.0/(1.0 + 50.0*b) + 40.0*b*b;
    break;
  default: /* flat-ish: exercises the factr stop */
    f = 1.0 + 1.0e-14*(a - 0.5)*(a - 0.5) + 1.0e-14*(b - 1.0)*(b - 1.0);
  }
  printf("E %a %a %a\n", a, b, f);
  return f;
}

int main(int argc, char **argv) {
  sscanf(argv[1], "%d", &which);
  double x[2], l[2], u[2];
  sscanf(argv[2], "%lf %lf %lf %lf %lf %lf",
         &x[0], &x[1], &l[0], &l[1], &u[0], &u[1]);
  int nbd[2] = {2, 2};
  findmax_bfgs(2, x, NULL, &obj, NULL, l, u, nbd, -1);
  printf("X %a %a\n", x[0], x[1]);
  return 0;
}
"""


def py_obj(which, p):
    a, b = float(p[0]), float(p[1])
    if which == 0:
        return 100.0 * (b - a * a) * (b - a * a) + (1.0 - a) * (1.0 - a) \
            + math.sqrt(a + 2.0)
    if which == 1:
        return (a - 2.0) * (a - 2.0) + 0.01 / (b + 0.1) + 3.0 * b
    if which == 2:
        return 1.0e4 * (a - 0.3) * (a - 0.3) * (1.0 + 5.0 * b) \
            + 700.0 / (1.0 + 50.0 * b) + 40.0 * b * b
    return 1.0 + 1.0e-14 * (a - 0.5) * (a - 0.5) \
        + 1.0e-14 * (b - 1.0) * (b - 1.0)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    d = tmp_path_factory.mktemp("optcompat")
    src = d / "probe.c"
    src.write_text(PROBE_C)
    exe = d / "probe"
    r = subprocess.run(
        ["g++", "-O2", "-w", f"-I{REF_SRC}/shared",
         str(src), str(REF_SRC / "shared" / "bfgs.cpp"),
         "-lm", "-o", str(exe)],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        pytest.skip(f"cannot build reference bfgs probe: {r.stderr[:500]}")
    return exe


CASES = [
    (0, (0.2, 0.6), (1e-15, 1e-15), (1 - 1e-15, 10.0)),
    (0, (0.9, 0.1), (1e-15, 1e-15), (1 - 1e-15, 10.0)),
    (1, (0.5, 5.0), (1e-15, 1e-15), (1 - 1e-15, 10.0)),
    (2, (0.5, 0.01), (1e-15, 1e-15), (1 - 1e-15, 10.0)),
    (2, (0.01, 9.9), (1e-15, 1e-15), (1 - 1e-15, 10.0)),
    (3, (0.2, 0.6), (1e-15, 1e-15), (1 - 1e-15, 10.0)),
    # fixed-parameter pinning (l == u), the F_fixed/alpha_fixed shape
    (2, (0.5, 0.01), (0.5, 1e-15), (0.5, 10.0)),
]


@pytest.mark.parametrize("which,x0,lo,hi", CASES)
def test_trajectory_bit_exact(probe, which, x0, lo, hi):
    args = f"{x0[0]} {x0[1]} {lo[0]} {lo[1]} {hi[0]} {hi[1]}"
    r = subprocess.run(
        [str(probe), str(which), args],
        capture_output=True, text=True, check=True,
    )
    ref_evals = []
    ref_x = None
    for ln in r.stdout.splitlines():
        parts = ln.split()
        if parts[0] == "E":
            ref_evals.append(tuple(float.fromhex(v) for v in parts[1:]))
        elif parts[0] == "X":
            ref_x = tuple(float.fromhex(v) for v in parts[1:])

    opt = RefLBFGSB(np.asarray(x0), np.asarray(lo), np.asarray(hi))
    my_evals = []
    guard = 0
    while not opt.done and guard < 10_000:
        guard += 1
        fs = []
        for p in opt.points():
            f = py_obj(which, p)
            my_evals.append((float(p[0]), float(p[1]), f))
            fs.append(f)
        opt.supply(fs)
    my_x = tuple(opt.x)

    # The reference driver evaluates f twice more at the start (once in
    # the driver, once inside getgradient's first FG_START round-trip);
    # compare as SETS of (x, f) prefix-matched by alignment on x values:
    # every evaluation WE make must appear in the reference's log at the
    # same relative order, and the endpoints must be bit-identical.
    assert my_x == ref_x, (
        f"endpoint differs: ours {tuple(v.hex() for v in map(float, my_x))} "
        f"vs ref {tuple(v.hex() for v in map(float, ref_x))}"
    )
    # subsequence check (order-preserving)
    it = iter(ref_evals)
    missing = []
    for e in my_evals:
        for re_ in it:
            if re_ == e:
                break
        else:
            missing.append(e)
    assert not missing, f"{len(missing)} evals diverge, first: {missing[:3]}"
