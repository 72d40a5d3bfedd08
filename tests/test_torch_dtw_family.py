"""The port's DTW family (``map/dtw_family.py``) against the JAX
package's ``dtw_batch``, bit for bit: every cell is one float32 ``abs``,
add or ``min`` on the same operands in both, with no reassociation."""

import numpy as np
import pytest
import torch

from rawalign_tpu.map import dtw_family as jfamily
from rawalign_tpu_torch.map import dtw_family as tfamily

torch.set_num_threads(1)


def _batch(rng, N, M, B=10):
    """Padded rows of unequal length (a length-1 row included); the pad
    holds noise, which no valid cell may read."""
    a = rng.normal(0, 1, (B, N)).astype(np.float32)
    b = rng.normal(0, 1, (B, M)).astype(np.float32)
    na = rng.integers(1, N + 1, B).astype(np.int32)
    nb = rng.integers(1, M + 1, B).astype(np.int32)
    na[0], nb[0], na[1], nb[1] = N, M, 1, M
    return a, b, na, nb


@pytest.mark.parametrize("shape", [(8, 6), (30, 17), (17, 45)])
@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("radius", [None, 3])
@pytest.mark.parametrize("exclude_last", [False, True])
def test_dtw_batch_matches_jax(shape, semiglobal, radius, exclude_last):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    a, b, na, nb = _batch(rng, *shape)
    kw = dict(semiglobal=semiglobal, radius=radius, exclude_last=exclude_last)
    want = np.asarray(jfamily.dtw_batch(a, b, na, nb, **kw))
    got = tfamily.dtw_batch(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(na), torch.from_numpy(nb), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    if radius is None:
        assert (want < 1e9).all()
