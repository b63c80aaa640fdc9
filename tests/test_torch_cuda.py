"""The port's CUDA kernels against their plain PyTorch versions on the
same GPU inputs, exact, at every engine bucket shape. Needs an NVIDIA GPU
and nvcc; skips without one. This file imports neither jax nor
rabbitsalign_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from rabbitsalign_tpu_torch.native.engine import engine_buckets
from rabbitsalign_tpu_torch.ops import extend_device as px
from rabbitsalign_tpu_torch.ops import sw_cuda, tb_cuda
from rabbitsalign_tpu_torch.ops.sw_cuda import SwParams

from .torch_extend_cases import mixed_pairs, q2_batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T", [(q, t) for q, t, _, _ in engine_buckets(150)])
@pytest.mark.parametrize("sw", [SwParams(2, 8, 12, 1), SwParams(1, 1, 2, 1)],
                         ids=["default", "flat"])
def test_kernels_match_plain_versions(cuda, Q, T, sw):
    buf, genome = q2_batch(mixed_pairs(Q, T, 70, seed=Q), Q, seed=Q)
    q_t, t_t, qlen, tlen = px.unpack_q2(
        torch.from_numpy(buf).to(cuda), px.resident_ref_codes(genome, cuda), Q, T)

    launches = sw_cuda.launches
    kernel = sw_cuda.sw_forward(q_t, t_t, qlen, tlen, sw)
    assert sw_cuda.launches == launches + 1
    plain = sw_cuda.sw_forward_plain(q_t, t_t, qlen, tlen, sw)
    for k, p in zip(kernel[:3], plain[:3]):
        assert torch.equal(k, p)
    qi = torch.arange(Q, device=cuda)[:, None, None]
    ti = torch.arange(T, device=cuda)[None, :, None]
    valid = (qi < qlen[None, None, :]) & (ti < tlen[None, None, :])
    assert torch.equal(torch.where(valid, kernel[3], 0), plain[3])

    launches = tb_cuda.launches
    walk = tb_cuda.sw_traceback(kernel[3], *kernel[:3])
    assert tb_cuda.launches == launches + 1
    for k, p in zip(walk, tb_cuda.sw_traceback_plain(kernel[3], *kernel[:3])):
        assert torch.equal(k, p)
