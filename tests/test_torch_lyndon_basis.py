"""The port's inverse of the Lyndon change of basis, taken block by block.

``repro_torch.core.lyndon._basis_change`` inverts M (Lyndon word i in
bracket j) by one unit-triangular solve a block of words with the same
letters, not by a dense inverse of the whole matrix.  It must give the
table the dense ``np.linalg.inv`` gives: exactly where that is integral,
else within 1e-12 of its largest entry (M and M^{-1} are integer matrices,
and the solves give them exactly, where the dense LU may round).
"""

import numpy as np
import pytest

from repro_torch.core import lyndon

CASES = [(1, 5), (2, 6), (2, 8), (3, 4), (3, 6), (4, 3), (4, 5), (5, 2), (5, 4),
         (6, 4), (8, 3), (8, 4)]


@pytest.mark.parametrize("d, depth", CASES, ids=[f"d{d}-N{n}" for d, n in CASES])
def test_block_inverse_equals_the_dense_inverse(d, depth):
    M, Minv = lyndon._basis_change(d, depth)
    n = lyndon.logsig_dim(d, depth)
    assert M.shape == Minv.shape == (n, n)
    dense = np.linalg.inv(M)
    if np.array_equal(dense, np.round(dense)):
        np.testing.assert_array_equal(Minv, dense)
    else:
        assert np.abs(Minv - dense).max() <= 1e-12 * np.abs(dense).max()
    assert np.array_equal(Minv, np.round(Minv))
    np.testing.assert_array_equal(M @ Minv, np.eye(n))
    # block-diagonal by length and lower-unitriangular, as M
    assert np.all(np.diag(Minv) == 1.0) and not np.triu(Minv, 1).any()
