"""The CUDA kernels K1 (sorted segment-sum), K2 (row gather) and K3
(unsorted scatter-add) of caster_dta_torch against their plain PyTorch
versions, and the autograd Functions built on them against the same
Functions on the CPU, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernels.py
"""
import os
import subprocess
import sys

import pytest
import torch

from caster_dta_torch.ops import cuda_segment as cs
from caster_dta_torch.ops import segment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    with pytest.raises(TypeError):
        cs.scatter_rows(table.double(), torch.zeros(2, 5, dtype=torch.int32, device=cuda), 5)
    with pytest.raises(ValueError):
        cs.scatter_rows(table, idx, 5)      # ids [2, 4] for rows [2, 5, 3]
    msgs = torch.randn(2, 4, 3, device=cuda)
    with pytest.raises(TypeError):
        cs.segment_sum_sorted(msgs.double(), idx, idx.bool(), 5)


def _k3_case(gen, b, e, n, f, dev, kind):
    """ids of one kind: uniform, all on one row, or only on the even rows
    below n // 2 (the odd and upper rows stay empty)."""
    if kind == "one row":
        ids = torch.full((b, e), n // 3, device=dev, dtype=torch.int32)
    elif kind == "empty rows":
        ids = torch.randint(0, max(n // 4, 1), (b, e), generator=gen, device=dev) * 2
    else:
        ids = torch.randint(0, n, (b, e), generator=gen, device=dev)
    rows = torch.randn(b, e, f, generator=gen, device=dev)
    return rows, ids.to(torch.int32).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,e,n,f,kind", [
    (32, 8192, 512, 28, "uniform"),     # flagship merged src||dst backward
    (32, 256, 64, 51, "uniform"),       # molecule gathers
    (32, 256, 64, 16, "uniform"),
    (3, 1000, 77, 5, "one row"),
    (2, 515, 130, 70, "empty rows"),     # F over one 64-column tile
    (2, 3000, 6000, 28, "uniform"),     # N above the JAX package's 4096 split
    (2, 0, 9, 4, "uniform"),
])
def test_k3_matches_plain(cuda, dtype, b, e, n, f, kind):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    rows, ids = _k3_case(gen, b, e, n, f, cuda, kind)
    rows = rows.to(dtype)
    before = cs.LAUNCHES[cs.K3]
    got = cs.scatter_rows(rows, ids, n).cpu()
    # the plain version on the CPU sums in edge order, as K3 does (on the
    # card index_add_ sums in atomic order, up to ~1e-4 off on a row of
    # ~1,000 terms)
    want = cs.scatter_rows_plain(rows.cpu(), ids.cpu(), n)
    assert got.dtype == torch.float32 and got.shape == (b, n, f)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[want.abs().sum(-1) == 0] == 0)
    assert cs.LAUNCHES[cs.K3] == before + (1 if b * n * f else 0)


def test_k3_traps_on_an_id_out_of_range(cuda):
    """The trap leaves the CUDA context unusable, so it runs in a child."""
    script = ("import sys, torch\n"
              "from caster_dta_torch.ops import cuda_segment as cs\n"
              "rows = torch.ones(1, 4, 3, device='cuda')\n"
              "ids = torch.tensor([[0, 1, 5, 2]], dtype=torch.int32, device='cuda')\n"
              "try:\n"
              "    cs.scatter_rows(rows, ids, 4)\n"
              "    torch.cuda.synchronize()\n"
              "except RuntimeError as e:\n"
              "    print('trapped:', e)\n"
              "    sys.exit(0)\n"
              "sys.exit(1)\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "trapped" in r.stdout, r.stdout + r.stderr
    with pytest.raises(IndexError, match="outside"):
        cs.scatter_rows(torch.ones(1, 4, 3), torch.tensor([[0, 1, 5, 2]], dtype=torch.int32), 4)


# f32 gradients: the same sums in another order. bf16 gradients are rounded
# from f32 sums once, so they may differ by one bf16 ulp (2**-8 relative).
GRAD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_match_the_cpu(cuda, dtype):
    """gather_nodes (K2, backward K3) and segment_sum (K1, backward K2) at
    the flagship shapes: card gradients against the CPU's."""
    gen = torch.Generator().manual_seed(3)
    b, n, e, f = 32, 512, 4096, 28
    dst = torch.sort(torch.randint(0, n - 1, (b, e), generator=gen), dim=1).values
    dst[:, -300:] = n - 1                       # padding edges, masked
    mask = torch.ones(b, e, dtype=torch.bool)
    mask[:, -300:] = False
    src = torch.randint(0, n, (b, e), generator=gen)
    idx = torch.cat([src, dst], dim=1).to(torch.int32)
    dst = dst.to(torch.int32)
    table = torch.randn(b, n, f, generator=gen).to(dtype)
    msgs = torch.randn(b, e, f, generator=gen).to(dtype)
    w_g = torch.randn(b, 2 * e, f, generator=gen)
    w_s = torch.randn(b, n, f, generator=gen)

    def grads(dev):
        t = table.to(dev).requires_grad_()
        m = msgs.to(dev).requires_grad_()
        out_g = segment.gather_nodes(t, idx.to(dev))
        out_s = segment.segment_sum(m, dst.to(dev), mask.to(dev), n)
        loss = (out_g.float() * w_g.to(dev)).sum() + (out_s.float() * w_s.to(dev)).sum()
        gt, gm = torch.autograd.grad(loss, (t, m))
        assert gt.dtype == dtype and gm.dtype == dtype
        return gt.cpu(), gm.cpu()

    before = dict(cs.LAUNCHES)
    g_card = grads(cuda)
    torch.cuda.synchronize()
    assert {k: cs.LAUNCHES[k] - before[k] for k in cs.LAUNCHES} == {cs.K1: 1, cs.K2: 2, cs.K3: 1}
    g_cpu = grads("cpu")
    for got, want in zip(g_card, g_cpu):
        torch.testing.assert_close(got.float(), want.float(), **GRAD_TOL[dtype])
    assert torch.all(g_card[1][:, -300:] == 0)  # masked edges get no gradient
