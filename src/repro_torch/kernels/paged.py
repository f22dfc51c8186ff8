"""Block-table-aware page ops for the paged KV cache (port of
`repro.kernels.paged`).

A paged cache stores every sequence buffer as a pool of fixed-size pages,
`(reps, n_pages, page_size, *tail)` (reps: the layers that share one
block table); a request owns an ordered list of page ids (its block-table
row) instead of a contiguous span.  Admission and eviction only change
page owners: the VP words inside pages are never copied or dequantized
when requests come and go.

These ops are the only code that touches the pool layout:

  * `gather_pages`      - block table -> contiguous per-request view
  * `scatter_pages`     - write whole pages (a prefill commits a prompt)
  * `scatter_positions` - write single positions (decode commits its
                          tokens; a chunked prefill a chunk that may
                          straddle pages)
  * `flip_bit`          - the chaos harness's one-bit corruption

The reference's ops are plain XLA gathers and scatters, with no Pallas
kernel; these are plain PyTorch index ops on device tensors.  The
scatters and `flip_bit` write the pool IN PLACE (the engine's CUDA
graphs own the pools' memory) and return it.  None of them reads a
device value on the host or indexes with a boolean mask, so a decode
step that uses them can be captured in a CUDA graph.

Page 0 is the DUMMY page: the free list never hands it out, and masked
writes (inactive batch rows) land there.  Nothing reads it back.
"""
from __future__ import annotations

import torch

# The signed integer type of each element width (bit views of a pool).
INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def gather_pages(pool: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Pool view through a block table.

    pool (reps, n_pages, page_size, *tail), page_ids (B, P) integer ->
    (reps, B, P * page_size, *tail): request b's pages concatenated in
    block-table order, a contiguous copy whose positions [0, lengths[b])
    are valid.
    """
    reps, _, ps = pool.shape[:3]
    B, P = page_ids.shape
    g = pool[:, page_ids.long()]               # (reps, B, P, ps, *tail)
    return g.reshape(reps, B, P * ps, *pool.shape[3:])


def scatter_pages(pool: torch.Tensor, page_ids: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """Write whole pages in place (one request's prefill commit).

    page_ids (P,), values (reps, P * page_size, *tail) -> pool.
    """
    reps, _, ps = pool.shape[:3]
    P = page_ids.shape[0]
    pool[:, page_ids.long()] = values.reshape(reps, P, ps, *pool.shape[3:])
    return pool


def scatter_positions(pool: torch.Tensor, page_ids: torch.Tensor,
                      offsets: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """Write single in-page positions in place (decode / chunked-prefill
    commit).

    page_ids and offsets of one shape I (a page per position; duplicates
    only on the dummy page 0), offsets in [0, page_size), values (reps,
    *I, *tail) -> pool.
    """
    pool[:, page_ids.long(), offsets.long()] = values
    return pool


def flip_bit(pool: torch.Tensor, page: int, offset: int,
             bit: int) -> torch.Tensor:
    """XOR one bit of the first stored element at (`page`, `offset`), in
    place, and return the pool.

    The fault-injection primitive of the chaos harness: it corrupts ONE
    packed VP word (or one float element, through a same-width integer
    view) as an HBM upset would; no other word changes.  Targets rep 0
    and the first tail element; `bit` is taken modulo the dtype's width.
    """
    nbits = pool.element_size() * 8
    bits = pool.view(INT_OF_WIDTH[pool.element_size()])
    idx = (0, page, offset) + (0,) * (pool.ndim - 3)
    # The mask as a signed integer of the width (bit nbits-1 is negative).
    mask = 1 << (bit % nbits)
    if mask >= 1 << (nbits - 1):
        mask -= 1 << nbits
    bits[idx] = bits[idx] ^ mask
    return pool
