"""The forward/backward log-likelihood agreement check of the EM loop
(models/driver.py): the reference's absolute tolerance in f64, widened
to the chains' own precision in f32."""

import numpy as np
import pytest

from ngsf_hmm.models.driver import convergence_loop, fwbw_tolerance
from ngsf_hmm.models.em import EMOptions


@pytest.mark.parametrize("dtype,gap,ok", [
    (np.float64, 0.0005, True),
    (np.float64, 0.19, False),  # the reference's 0.001 holds in f64
    (np.float32, 0.19, True),  # 3 ulps of a 1M-site f32 likelihood
    (np.float32, 5.0, False),  # a real mismatch still stops the run
    (np.float32, np.nan, False),
])
def test_fwbw_check_scales_with_precision(dtype, gap, ok):
    N = 3
    lkl = np.full((N,), -5.0e5, dtype)

    def step(state, active):
        return state, lkl, np.asarray([gap])

    opts = EMOptions(min_iters=1, max_iters=1)
    run = lambda: convergence_loop(step, 0, opts, n_ind=N)  # noqa: E731
    if ok:
        run()
    else:
        with pytest.raises(RuntimeError, match="do not match"):
            run()


def test_fwbw_tolerance_keeps_the_reference_floor():
    assert fwbw_tolerance(0.001, np.float64, np.array([-10.0])) == 0.001
    assert fwbw_tolerance(0.001, np.float32, np.array([-1.0])) == 0.001
    t = fwbw_tolerance(0.001, np.float32, np.array([-5.0e5, -2.0]))
    assert t == pytest.approx(32 * np.finfo(np.float32).eps * 5.0e5)
