"""The overlap-save halo exchange of the time-parallel stream
(shard/time_parallel.halo_from_right) on a 1-D mesh against a NumPy
shift of the shard heads (SURVEY.md §5.2)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ofdm_uhd_tpu.shard.time_parallel import halo_from_right


@pytest.mark.parametrize("t", [1, 8])
def test_halo_from_right_matches_numpy(t):
    mesh = Mesh(np.array(jax.devices()[:t]), ("time",))
    h = 128
    rng = np.random.default_rng(t)
    x = (rng.standard_normal((t * 2 * h,))
         + 1j * rng.standard_normal((t * 2 * h,))).astype(np.complex64)
    got = np.asarray(jax.jit(jax.shard_map(
        lambda block: halo_from_right(block[:h], "time"), mesh=mesh,
        in_specs=P("time"), out_specs=P("time"), check_vma=False))(x))
    heads = x.reshape(t, 2 * h)[:, :h]
    want = np.concatenate([heads[1:], np.zeros_like(heads[:1])]).reshape(-1)
    np.testing.assert_array_equal(got, want)
