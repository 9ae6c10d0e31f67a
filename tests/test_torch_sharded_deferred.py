"""The sharded engine's deferred path, its 2-D mesh and its restore on gloo
ranks against the JAX package's ShardedTpuBwt and TpuBwt, field by field
per rank after every batch (the harness is tests/test_torch_sharded.py's;
a file of its own so that the two halves run side by side)."""

import pytest

from test_torch_sharded import held_to_jax


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_deferred_mesh2d_restore_match_jax(d, tmp_path):
    """defer_r 4 in each sorting order (per-rank pending indexes, the
    virtual-range routing, the spill's hop at each flush), the (2, d / 2)
    mesh with and without deferral, and from_single: ShardedTorchBwt on d
    gloo ranks == ShardedTpuBwt on d devices, and == TpuBwt."""
    held_to_jax(d, "deferred", tmp_path)
