"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here is marked ``cuda`` and skips on a machine
without a CUDA device.  This file imports neither JAX nor the reference
package, so it also runs where JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

# The kernel and its plain version add the same fp32 values in the same
# order without fused multiply-adds, so they should agree bit for bit;
# the tolerance is that of the reference comparison (different orders).
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (sm_90a)")
    return torch.device("cuda")


def _inputs(b, n, d, t, seed, device):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((b, n, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, t)).astype(np.int32)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(idx).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,t", [(3, 40, 96, 13), (4, 64, 4096, 512),
                                     (2, 17, 30, 21), (1, 8, 1028, 0)])
def test_kernel_matches_plain_version(cuda, b, n, d, t):
    x, i = _inputs(b, n, d, t, b + n + d + t, cuda)
    before = ops.launch_count()
    got = ops.subsample_stats(x, i)
    torch.cuda.synchronize()
    assert ops.launch_count() == before + 1
    want = ref.subsample_stats_ref(x, i)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    singles = torch.cat([ops.subsample_stats(x[k:k + 1], i[k:k + 1])
                         for k in range(b)])
    assert torch.equal(got, singles)


@pytest.mark.cuda
def test_kernel_rejects_cpu_indices_with_cuda_data(cuda):
    x, i = _inputs(1, 8, 16, 8, 0, cuda)
    with pytest.raises(ValueError):
        ops.subsample_stats(x, i.cpu())
