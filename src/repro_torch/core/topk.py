"""Streaming top-K reservoir on torch tensors — the port of the reference's
``core.topk`` (the paper's per-document ``H.insert / indexof`` loop, Fig.
2/3, vectorized: each update merges a batch of scored documents into the
reservoir with one sort).

Every function works on the last axis, so one code path serves a single
stream (state of shape (K,)) and a fleet (state (M, K), the leading
stream axis the reference gets from ``jax.vmap``). Functions are pure:
they return new tensors on the device of their inputs.

Order: descending score, lower id first on ties — the reference's
``jnp.lexsort((ids, -scores))``. torch has no lexsort, so the order is one
sort of a packed int64 key (``rank_key``). Like JAX's sort comparator the
key treats -0.0 as +0.0 and every NaN as one value that sorts last, so
ties between signed zeros fall to the id as they do in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import device as device_mod

_INT32_MAX = 2 ** 31 - 1


class ReservoirState(NamedTuple):
    scores: torch.Tensor  # (..., K) float32, sorted descending, -inf padded
    ids: torch.Tensor  # (..., K) int32 stream position, -1 padded
    seen: torch.Tensor  # (...) int32 — documents observed


def init(k: int, device=None) -> ReservoirState:
    """Empty reservoir of width ``k`` on ``device`` (the CUDA card unless
    given; see ``repro_torch.device``)."""
    dev = device_mod.resolve(device)
    return ReservoirState(
        scores=torch.full((k,), float("-inf"), dtype=torch.float32,
                          device=dev),
        ids=torch.full((k,), -1, dtype=torch.int32, device=dev),
        seen=torch.zeros((), dtype=torch.int32, device=dev),
    )


def ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 that orders like float32 ``x`` in IEEE total order
    (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN)."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & _INT32_MAX)


def rank_key(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 key whose ascending order is (score descending, id
    ascending) — ``jnp.lexsort((ids, -scores))`` as one sortable value.
    The high 32 bits reverse the score order; -0.0 is folded onto +0.0
    first and NaN goes last, as in JAX's sort comparator. The low 32 bits
    are the id offset by 2**31, so id -1 (padding) orders below id 0."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    hi = torch.where(torch.isnan(scores),
                     torch.full_like(scores, _INT32_MAX, dtype=torch.int32),
                     ~ordered_bits(s))
    return hi.to(torch.int64) * 2 ** 32 + (ids.to(torch.int64) + 2 ** 31)


def top_k_positions(x: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest values along the last axis in
    ``jax.lax.top_k``'s order: IEEE total order (so +0.0 ranks above
    -0.0), ties to the lower position. One sort of a unique int64 key
    (value high, position low)."""
    pos = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    key = (~ordered_bits(x)).to(torch.int64) * 2 ** 32 + pos
    return torch.sort(key, dim=-1).indices[..., :k]


def member(needles: torch.Tensor, haystack: torch.Tensor) -> torch.Tensor:
    """Boolean mask ``needles[..., i] in haystack[...]`` by sort + binary
    search, O((H+N)·log H) per row."""
    hs = torch.sort(haystack, dim=-1).values
    pos = torch.searchsorted(hs, needles.contiguous())
    pos = pos.clamp_(max=hs.shape[-1] - 1)
    return torch.gather(hs, -1, pos) == needles


def _top_by_rank(scores: torch.Tensor, ids: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Positions of the k best (score, id) pairs, best first. Keys tie
    only between identical (score, id) pairs, which are interchangeable,
    so an unstable sort gives the reference's result."""
    return torch.sort(rank_key(scores, ids), dim=-1).indices[..., :k]


def update(state: ReservoirState, batch_scores: torch.Tensor,
           batch_ids: torch.Tensor) -> Tuple[ReservoirState, torch.Tensor]:
    """Merge a batch (..., W) into the reservoir (..., K).

    Returns (new_state, wrote) where ``wrote[..., j]`` is True iff batch
    element j entered the reservoir (⇒ one storage write, paper eq.
    9/10). Batch elements whose id is already resident are dropped.
    Within-batch ids are assumed unique (they are stream positions).
    """
    k = state.scores.shape[-1]
    batch_scores = batch_scores.to(torch.float32)
    batch_ids = batch_ids.to(torch.int32)
    resident = member(batch_ids, state.ids)
    cand_scores = torch.where(resident, float("-inf"), batch_scores)
    cand_ids = torch.where(resident, -1, batch_ids)
    all_scores = torch.cat([state.scores, cand_scores], dim=-1)
    all_ids = torch.cat([state.ids, cand_ids], dim=-1)
    top = _top_by_rank(all_scores, all_ids, k)
    # positional membership, not id membership: an id collision with a
    # resident entry must not report a write for the colliding element
    selected = torch.zeros(all_ids.shape, dtype=torch.bool,
                           device=all_ids.device).scatter_(-1, top, True)
    wrote = selected[..., k:] & (cand_ids >= 0)
    new_state = ReservoirState(
        scores=torch.gather(all_scores, -1, top),
        ids=torch.gather(all_ids, -1, top),
        seen=state.seen + batch_ids.shape[-1],
    )
    return new_state, wrote


def evicted(old: ReservoirState, new: ReservoirState) -> torch.Tensor:
    """Mask over ``old.ids`` of entries no longer present in ``new`` —
    the documents whose storage can be freed (paper §VI)."""
    return (old.ids >= 0) & ~member(old.ids, new.ids)


def merge(a: ReservoirState, b: ReservoirState) -> ReservoirState:
    """Merge two sub-stream reservoirs (cross-shard reduction);
    associative and commutative up to the deterministic tie-break."""
    k = a.scores.shape[-1]
    scores = torch.cat([a.scores, b.scores], dim=-1)
    ids = torch.cat([a.ids, b.ids], dim=-1)
    top = _top_by_rank(scores, ids, k)
    return ReservoirState(scores=torch.gather(scores, -1, top),
                          ids=torch.gather(ids, -1, top),
                          seen=a.seen + b.seen)


def threshold(state: ReservoirState) -> torch.Tensor:
    """Current K-th score (entry bar). -inf while the reservoir is unfull."""
    return state.scores[..., -1]


def tier_of(ids: torch.Tensor, r) -> torch.Tensor:
    """Algorithm C placement: tier 0 (A) for stream index < r, else 1 (B).
    The compare runs in float32, as the reference's does."""
    r = torch.as_tensor(r, dtype=torch.float32, device=ids.device)
    return (ids >= r).to(torch.int32)
