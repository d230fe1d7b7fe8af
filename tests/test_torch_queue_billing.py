"""How a run bills its likelihood evaluations to its records, in both
packages: in batch mode every evaluation stands in some record's
``ncall``; in queue mode (``proposal_mode='queue'``) the evaluations of
the proposals consumed after the last accepted one stand in none, so the
records' ``ncall`` sums to less than the sampler's.  The JAX package does
the same (a known fault of the reference, ROADMAP Queue 3), so the port
keeps its accounting; this test pins both.

The two packages draw different random numbers, so the runs differ: the
test holds each package to the same accounting, not the two runs to each
other.
"""

import numpy as np
import pytest
import torch

import dynesty_tpu_torch as dyt

from utils import get_rstate

torch.set_num_threads(1)

NDIM = 3
_C = np.identity(NDIM)
_C[_C == 0] = 0.95
_CINV = np.linalg.inv(_C)
_LNORM = -0.5 * (np.log(2 * np.pi) * NDIM + np.log(np.linalg.det(_C)))
_CINV_T = torch.as_tensor(_CINV)


@pytest.fixture(scope="module")
def jax_pkg():
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX comparisons run under tests/conftest.py "
                    "(JAX on the CPU in float64)")
    import jax.numpy as jnp

    import dynesty_tpu
    return dynesty_tpu, jnp


def _unbilled(pkg, mode, jnp=None):
    """``ncall`` less the records' ``ncall`` of a small single/rslice
    run, and the records' ``ncall`` column."""
    kw = dict(nlive=100, bound="single", sample="rslice", queue_size=32,
              proposal_mode=mode, rstate=get_rstate(1))
    if jnp is None:
        s = pkg.NestedSampler(lambda x: -0.5 * (x @ _CINV_T @ x) + _LNORM,
                              lambda u: 10.0 * (2.0 * u - 1.0), NDIM,
                              device="cpu", **kw)
    else:
        cinv = jnp.asarray(_CINV)
        s = pkg.NestedSampler(lambda x: -0.5 * jnp.dot(x, cinv @ x) + _LNORM,
                              lambda u: 10.0 * (2.0 * u - 1.0), NDIM, **kw)
    s.run_nested(print_progress=False, dlogz=0.5)
    col = np.asarray(s.results.ncall)
    return int(s.ncall) - int(col.sum()), col


@pytest.mark.parametrize("mode", ["batch", "queue"])
def test_queue_mode_bills_its_last_consumed_proposals_to_no_record(
        jax_pkg, mode):
    jpkg, jnp = jax_pkg
    port, port_col = _unbilled(dyt, mode)
    ref, ref_col = _unbilled(jpkg, mode, jnp)
    # every record bills at least its own proposal in both packages
    assert port_col.min() >= 1 and ref_col.min() >= 1
    if mode == "batch":
        assert port == ref == 0
    else:
        # both leave the tail of the last dispatch unbilled, less than one
        # round's proposals can cost (q lanes of at most a few hundred
        # evaluations each)
        assert 0 < port < 32 * 1000 and 0 < ref < 32 * 1000
