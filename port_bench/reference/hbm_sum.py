"""The HBM probe's checksum in plain arithmetic.

The probe reads an all-ones float32 array of ``rows × lanes`` elements
``sweeps`` times and returns the sum, which is exact: ``rows × lanes ×
sweeps``, well inside the 2**53 that a float64 holds exactly. The array's
rows are the configuration's megabytes in rows of ``lanes`` floats, at
least one chunk and cut to whole chunks.
"""

from __future__ import annotations

import torch


def rows(size_mb: int, lanes: int, chunk_rows: int) -> int:
    n = max(chunk_rows, size_mb * 1024 * 1024 // (lanes * 4))
    return n - n % chunk_rows


def exact_sum(numel: int, sweeps: int) -> float:
    return float(numel * sweeps)


def bf16_sum(lanes: int, count: int) -> float:
    """The control: the same sum with one bf16 accumulator a lane, each
    adding its ``count`` ones in order. A bf16 accumulator stops growing
    once the spacing of its values passes 1 (at 256), so the loop ends
    there."""
    acc = torch.zeros((), dtype=torch.bfloat16)
    one = torch.ones((), dtype=torch.bfloat16)
    for _ in range(count):
        nxt = acc + one
        if nxt == acc:
            break
        acc = nxt
    return float(lanes) * float(acc)
