"""The CUDA kernels K1 (sorted segment-sum) and K2 (row gather) of
caster_dta_torch against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels.py
"""
import pytest
import torch

from caster_dta_torch.ops import cuda_segment as cs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _sorted_case(gen, b, n, e, f, dev, dtype=torch.float32):
    dst = torch.sort(torch.randint(0, n, (b, e), generator=gen, device=dev), dim=1).values
    mask = torch.rand(b, e, generator=gen, device=dev) < 0.85
    msgs = torch.randn(b, e, f, generator=gen, device=dev).to(dtype)
    return msgs, dst.to(torch.int32), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,e,f", [(32, 512, 4096, 28), (32, 64, 256, 51), (3, 77, 1000, 5),
                                     (2, 40, 0, 9)])
def test_k1_matches_plain(cuda, dtype, b, n, e, f):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    msgs, dst, mask = _sorted_case(gen, b, n, e, f, cuda, dtype)
    before = cs.LAUNCHES[cs.K1]
    with torch.no_grad():
        got = cs.segment_sum_sorted(msgs, dst, mask, n)
        torch.cuda.synchronize()
    want = cs.segment_sum_sorted_plain(msgs, dst, mask, n)
    assert got.dtype == torch.float32
    # f32 sums of the same terms in edge order vs atomic order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert cs.LAUNCHES[cs.K1] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,e,f", [(32, 512, 8192, 28), (32, 64, 256, 51), (2, 9, 13, 1)])
def test_k2_bit_exact(cuda, dtype, b, n, e, f):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    table = torch.randn(b, n, f, generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, n, (b, e), generator=gen, device=cuda, dtype=torch.int32)
    with torch.no_grad():
        got = cs.gather_rows(table, idx)
        torch.cuda.synchronize()
    assert torch.equal(got, cs.gather_rows_plain(table, idx))


def test_kernels_refuse_what_they_do_not_take(cuda):
    table = torch.randn(2, 5, 3, device=cuda)
    idx = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cs.gather_rows(table, idx.long())
    with pytest.raises(ValueError):
        cs.gather_rows(table.transpose(1, 2), idx)
    with pytest.raises(RuntimeError, match="no backward"):
        cs.gather_rows(table.requires_grad_(), idx)
    msgs = torch.randn(2, 4, 3, device=cuda)
    with pytest.raises(TypeError):
        cs.segment_sum_sorted(msgs.double(), idx, idx.bool(), 5)
