"""Rendezvous (HRW) hashing: ruleset digest -> stable member ordering.

The fleet plane routes ScanSecrets traffic by *ruleset digest*, because
residency is the expensive thing a host accumulates: a member that has
already compiled/admitted a digest (the tenancy pool) and holds its
built executables (the executable cache) serves it far cheaper than a
cold one.
Highest-random-weight hashing gives every digest a stable primary plus a
deterministic spillover order with the two properties routing needs:

- placement is a pure function of (member name, weight, digest) — no
  shared state, so every client and every restart computes the same
  answer (the affinity property);
- when a member joins or leaves, only the digests whose primary changes
  move (~1/N of them), instead of the wholesale reshuffle a modular hash
  causes — warm pools on the surviving members stay warm.

Weights use the logarithmic method (weighted rendezvous hashing): score
= -w / ln(u) with u derived uniformly from the hash, so a weight-2
member wins ~2x the digests of a weight-1 member, exactly.
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterable, Protocol


class _Weighted(Protocol):
    name: str
    weight: float


def _uniform(member_name: str, key: str) -> float:
    """Deterministic uniform draw in (0, 1) for the (member, key) pair.

    blake2b is keyed by content only — no process seed — which is what
    makes placement identical across clients and restarts.  The +0.5
    offset keeps the draw strictly inside (0, 1) so ln(u) below is
    always finite and negative.
    """
    h = hashlib.blake2b(
        member_name.encode("utf-8") + b"\x00" + key.encode("utf-8"),
        digest_size=8,
    ).digest()
    return (int.from_bytes(h, "big") + 0.5) / float(1 << 64)


def score(member_name: str, weight: float, key: str) -> float:
    """The member's rendezvous score for `key`; higher wins.  Weight 0
    (or negative) scores 0.0 — such a member can only be chosen when
    every positively-weighted member is unroutable."""
    w = float(weight)
    if w <= 0.0:
        return 0.0
    return -w / math.log(_uniform(member_name, key))


def candidates(key: str, members: Iterable[_Weighted]) -> list:
    """Members ordered by rendezvous score for `key`, best first: index 0
    is the digest's primary, the rest the spillover order.  Ties (only
    possible for duplicate names) break by name so the order is total
    and deterministic."""
    return sorted(
        members,
        key=lambda m: (-score(m.name, m.weight, key), m.name),
    )


def primary(key: str, members: Iterable[_Weighted]):
    """The digest's stable owner, or None with no members."""
    ordered = candidates(key, members)
    return ordered[0] if ordered else None
