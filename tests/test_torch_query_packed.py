"""The port's FM-index queries on the 4-bit packed tier against the JAX
package's on the same index (a TpuBwt build under ROPEBWT2_TPU_PACK4=1,
carried over with convert.py), at so 0, 1 and 2.  Exact (integers)."""

import pytest

from test_torch_query import check_against_jax, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("so", [0, 1, 2])
def test_packed_queries_match_jax(so, monkeypatch):
    check_against_jax(128, so, pack4=True, monkeypatch=monkeypatch)
