#!/usr/bin/env python3
"""How far a split row sum lands from K3's plain version, on the CPU.

K3 (``caster_dta_torch.ops.cuda_segment.scatter_rows``) is held against its
plain version, an ``index_add_`` on the CPU that sums each row in f32 in edge
order, within rtol = atol = 1e-5. This script sums the same rows the way a
split kernel would (pieces of P consecutive ids of a row's CSR range, each
summed in order, the partials then added in piece order) and prints, for the
rows with more than P ids, the largest |split - plain| over the row's
features divided by the tolerance 1e-5 + 1e-5 * |plain|. A ratio above 1
fails the check. It also prints the skew of the ids: the mean count on rows 0
and N-1 (where padding edges put their src and dst), the largest row, and the
rows over 64 ids per graph.

    python3 scripts/k3_split_sum_error.py [--pieces 64 128]

Inputs, rows drawn N(0, 1) from a seed (f32 and rounded to bf16): the merged
src||dst ids of the flagship and large-protein buckets
(``synthetic_pair_batch``, the ids that training gives K3) and all ids of a
graph on one row.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from caster_dta_torch.data.batching import synthetic_pair_batch  # noqa: E402
from caster_dta_torch.ops import cuda_segment as cs  # noqa: E402

RTOL = ATOL = 1e-5


def split_sum(rows: torch.Tensor, ids: torch.Tensor, n: int, piece: int) -> torch.Tensor:
    """Each row's CSR range cut into pieces of ``piece`` ids, each summed in
    order, the partials added in piece order -> [B, N, F] f32."""
    b, e, f = rows.shape
    row_ptr, perm = cs.scatter_csr_plain(ids, n)
    out = torch.zeros(b, n, f)
    for g in range(b):
        sorted_ids = ids[g].long()[perm[g].long()]
        pos = torch.arange(e) - row_ptr[g].long()[sorted_ids]
        piece_of = sorted_ids * (e // piece + 1) + pos // piece   # pieces in (row, piece) order
        uniq, inverse = torch.unique(piece_of, return_inverse=True)
        partial = torch.zeros(len(uniq), f).index_add_(0, inverse, rows[g].float()[perm[g].long()])
        out[g].index_add_(0, uniq // (e // piece + 1), partial)
    return out


def cases(seed: int):
    gen = torch.Generator().manual_seed(seed)
    for label, size in (("flagship", dict(b=32, n_p=512, e_p=4096, n_m=64, e_m=256)),
                        ("large protein", dict(b=4, n_p=4608, e_p=65536, n_m=128, e_m=1024))):
        p = synthetic_pair_batch(**size, seed=0).protein
        ids = torch.cat([p.edge_src, p.edge_dst], 1).to(torch.int32)
        yield f"{label} merged ids {tuple(ids.shape)} -> N={p.n_pad}", ids, p.n_pad, gen
    ids = torch.full((2, 16384), 3, dtype=torch.int32)
    yield "all 16,384 ids of a graph on one row", ids, 9, gen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pieces", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(f"torch {torch.__version__}, CPU; tolerance rtol {RTOL} atol {ATOL}")
    for what, ids, n, gen in cases(args.seed):
        b, e = ids.shape
        counts = torch.stack([torch.bincount(ids[g].long(), minlength=n) for g in range(b)])
        print(f"{what}: ids on row 0 (mean) {counts[:, 0].float().mean().item():.1f}, on row "
              f"N-1 {counts[:, -1].float().mean().item():.1f}, largest row "
              f"{int(counts.max())}, rows over 64 ids per graph "
              f"{(counts > 64).sum().item() / b:.2f}")
        for dtype in (torch.float32, torch.bfloat16):
            rows = torch.randn(b, e, 28, generator=gen).to(dtype)
            plain = cs.scatter_rows_plain(rows, ids, n)
            for piece in args.pieces:
                got = split_sum(rows, ids, n, piece)
                ratio = ((got - plain).abs() / (ATOL + RTOL * plain.abs())).amax(-1)
                long_rows = counts > piece
                worst = ratio[long_rows]
                print(f"{what} {str(dtype)[6:]} P={piece}: {int(long_rows.sum())} rows over P "
                      f"(largest {int(counts.max())} ids); error / tolerance max "
                      f"{worst.max().item():.3f}, rows over 1: {int((worst > 1).sum())}; rows "
                      f"of at most P ids equal bit for bit: "
                      f"{torch.equal(got[~long_rows], plain[~long_rows])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
