"""The split-K partition law shared by the decode kernel, its plain
version, the oracle and the auto-tuner (a copy of
``repro.kernels.paged_attention.contracts.decode_partition``)."""

from __future__ import annotations

from typing import Tuple


def decode_partition(max_pages: int, pages_per_block: int = 1,
                     num_splits: int = 1) -> Tuple[int, int, int, int]:
    """Clamp knobs and derive the kernel's split/block partition.

    Returns ``(pages_per_block, n_blocks, num_splits, blocks_per_split)``.
    Every consumer must agree bit for bit on which pages land in which
    split, so the port's ``(m, l, acc)`` partials compare with the JAX
    package's split by split.
    """
    max_pages = max(1, int(max_pages))
    ppb = max(1, min(int(pages_per_block), max_pages))
    n_blocks = -(-max_pages // ppb)
    ns = max(1, min(int(num_splits), n_blocks))
    bps = -(-n_blocks // ns)  # last split may cover padding blocks
    return ppb, n_blocks, ns, bps
