"""PyTorch port, utils/debugging.py: the printers write what the JAX
package's write, for numpy arrays and for tensors."""

import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.utils import debugging as ref
from symmetric_eigenvalue_tpu_torch.utils import debugging as port


@pytest.mark.parametrize("n", [1, 2, 5])
def test_printers_match_jax(n, capsys):
    rng = np.random.default_rng(n)
    d = rng.standard_normal(n) * 5.0
    e = rng.standard_normal(max(n - 1, 0)) * 2.0
    M = rng.standard_normal((n, n + 1))

    def drive(mod, conv):
        mod.print_tridiagonal_matrix(conv(d), conv(e))
        mod.print_vector(conv(d))
        mod.print_matrix(conv(M))
        return capsys.readouterr().out

    want = drive(ref, np.asarray)
    assert want.count("\n") == n + 1 + n
    assert drive(port, np.asarray) == want
    assert drive(port, torch.as_tensor) == want
