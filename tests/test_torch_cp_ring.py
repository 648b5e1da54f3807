"""The port's ring at cp 4 against the JAX package's.

Four spawned gloo ranks (``test_torch_cp_ranks.py``) against JAX
``ring_self_attention`` on 4 virtual CPU devices, forward and dq, dk, dv,
causal and bidirectional, fp32 at 1e-5. At cp 4 the causal hops take both
branches of the hop classifier (src < me and src > me) and the dk/dv
accumulators travel up to three shifts before the last one home.
"""

import numpy as np
import pytest

from test_torch_context_parallel import TOL, jax_ring, ring_case
from test_torch_cp_ranks import ring


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_matches_jax_ring_at_cp4(causal):
    q, k, v, do = ring_case(4, seed=4)
    got = ring(q, k, v, do, cp=4, causal=causal)
    want = jax_ring(q, k, v, do, 4, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
