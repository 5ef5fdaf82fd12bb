"""Pin the taus RNG (io/gsl_rng.py AND tests/gsl_shim) to real GSL.

The reference seeds gsl_rng_taus for its random inits
(/root/reference/parse_args.cpp:232-233). Both taus implementations in
this repo were written here, so testing them against each other alone is
circular (round-3 VERDICT "Missing #2"). This module anchors them to
GSL's OWN published self-test value:

    GSL rng/test.c:  rng_test (gsl_rng_taus, 1, 10000, 2733957125);

i.e. with seed 1, the 10000th 32-bit output word of gsl_rng_taus is
2733957125. Any drift in the seeding LCG, the state clamps, the 6-step
warm-up, or the Tausworthe step constants changes that word. The other
seeds' first-word pins below are regression fixtures frozen from the
anchored implementation (GSL publishes only the seed-1 value).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ngsf_hmm.io.gsl_rng import GslTaus

REPO = Path(__file__).resolve().parent.parent

# GSL's own self-test anchor (rng/test.c)
GSL_ANCHOR_SEED = 1
GSL_ANCHOR_N = 10000
GSL_ANCHOR_WORD = 2733957125

# First-8 output words per seed, frozen from the anchored implementation.
# Seed 0 must equal seed 1: GSL maps seed 0 -> 1 before the seeding LCG.
PINS = {
    0: [802792108, 4084684829, 2342628799, 320516809,
        984487517, 2246144618, 398433606, 2198246467],
    1: [802792108, 4084684829, 2342628799, 320516809,
        984487517, 2246144618, 398433606, 2198246467],
    4357: [1777360508, 1239859514, 3701636639, 3955383357,
           2353439451, 1086096897, 4046938633, 3749031105],
    12345: [604716153, 3670082527, 2361899765, 2078690716,
            1650372189, 2748434131, 646518071, 3945595778],
}


def test_python_taus_matches_gsl_published_value():
    g = GslTaus(GSL_ANCHOR_SEED)
    w = None
    for _ in range(GSL_ANCHOR_N):
        w = g._get()
    assert w == GSL_ANCHOR_WORD


@pytest.mark.parametrize("seed", sorted(PINS))
def test_python_taus_word_pins(seed):
    g = GslTaus(seed)
    assert [g._get() for _ in range(8)] == PINS[seed]


def test_uniform_is_word_over_2_32():
    g1, g2 = GslTaus(4357), GslTaus(4357)
    words = np.array([g2._get() for _ in range(16)], np.float64)
    np.testing.assert_array_equal(g1.uniforms(16), words / 4294967296.0)


@pytest.fixture(scope="module")
def shim_words(tmp_path_factory):
    """Compile a probe against tests/gsl_shim/gsl/gsl_rng.h and dump
    words for every pinned seed + the GSL anchor."""
    d = tmp_path_factory.mktemp("gslshim")
    src = d / "probe.c"
    src.write_text(
        '#include <stdio.h>\n#include "gsl/gsl_rng.h"\n'
        "int main(int argc, char **argv) {\n"
        "  unsigned long seed; int n; unsigned long w = 0;\n"
        "  sscanf(argv[1], \"%lu\", &seed); sscanf(argv[2], \"%d\", &n);\n"
        "  gsl_rng *r = gsl_rng_alloc(gsl_rng_taus);\n"
        "  gsl_rng_set(r, seed);\n"
        "  for (int i = 0; i < n; i++) {\n"
        "    w = _gsl_shim_taus_get(r);\n"
        "    if (n <= 16) printf(\"%lu\\n\", w);\n"
        "  }\n"
        "  if (n > 16) printf(\"%lu\\n\", w);\n"
        "  return 0;\n"
        "}\n"
    )
    exe = d / "probe"
    try:
        subprocess.run(
            ["gcc", "-O2", "-w", f"-I{REPO}/tests/gsl_shim",
             str(src), "-o", str(exe)],
            check=True, capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"no C compiler for the shim probe: {e}")

    def run(seed, n):
        out = subprocess.run(
            [str(exe), str(seed), str(n)], check=True,
            capture_output=True, text=True,
        ).stdout.split()
        return [int(x) for x in out]

    return run


def test_shim_matches_gsl_published_value(shim_words):
    assert shim_words(GSL_ANCHOR_SEED, GSL_ANCHOR_N)[-1] == GSL_ANCHOR_WORD


@pytest.mark.parametrize("seed", sorted(PINS))
def test_shim_word_pins(shim_words, seed):
    assert shim_words(seed, 8) == PINS[seed]
