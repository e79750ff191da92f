"""Three Harmony rounds of the port's rotate route on a mesh against the
JAX package's mesh engine: R written (objective rtol 1e-5) and virtual R
(1e-4), Z_corr and R atol 1e-4, the gathered state (the stacked penalty
tables and the global block ids under virtual R) equal to the JAX state's
global arrays, and every rank's centroids equal bit for bit; at N = 4096
and at N = 3600 (pad cells in the last shard), on 2 and on 4 gloo ranks
on the CPU. The cases, the ranks and the bounds are those of
``test_torch_mesh.py`` (its module docstring), whose file the ranks run;
each world size starts once, every rank within its own time limit.
"""

import numpy as np
import pytest

import test_torch_mesh as tm

ROUND_CASES = (("rotate", 4096, 2), ("rotate", 3600, 4), ("virtual", 4096, 4),
               ("virtual", 3600, 2))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for n in tm.SIZES:
        the_spec = tm.spec(n, engine=ROUND_CASES)
        out[n] = (the_spec, tm.start_ranks(tmp_path_factory.mktemp(f"rounds{n}"), n, the_spec))
    return out


@pytest.mark.parametrize("mode,N,n", ROUND_CASES)
def test_three_rotate_rounds_match_jax_mesh_engine(ranks, mode, N, n):
    tm.check_three_rounds(ranks, mode, N, n)
    assert np.isfinite(ranks[n][1][0][f"{mode}{N}/Z_corr"]).all()
