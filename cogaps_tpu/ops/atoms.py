"""Device-resident atomic domain.

The reference stores atoms of the 2^64-position 1-D domain in a sorted
map + unsorted vector with cached neighbor pointers
(reference: src/atomic/AtomicDomain.{h,cpp}, ConcurrentAtomicDomain.{h,cpp}).
That representation is pointer-chasing and inherently serial.

Design delta (same stationary distribution, documented in SURVEY.md §7.1):
every observable statistic of the sampler depends only on which matrix
*element* (bin) an atom occupies and its mass — exact 2^64 positions only
enter through (a) uniform free-position sampling, which at realistic atom
counts is indistinguishable from uniform element sampling (collision
probability ~ n/2^64), and (b) neighbor selection for move/exchange, which
is a *proposal choice*, not part of the target density (positions carry a
uniform prior). We therefore store atoms as a fixed-capacity COMPACT table
of (element, mass) pairs: live atoms occupy slots [0, n), so a uniform
rank over live atoms IS a slot index (the reference keeps an unsorted
vector for the same O(1) uniform pick, AtomicDomain.cpp:24-29). The sweep
maintains compactness with O(batch) work per sweep: births append at the
top, and each killed slot below the new live boundary is refilled from
the tail — the vectorized analog of the reference's swap-with-back erase
(AtomicDomain.cpp:80-111). A hole-based table would need an
O(capacity) rank search per pick instead; the compact layout needs none.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class AtomTable:
    """Fixed-capacity atom storage with holes (live iff elem >= 0)."""

    mass: jnp.ndarray  # (capacity,) float32, 0 where empty
    elem: jnp.ndarray  # (capacity,) int32, matrix element index, -1 where empty
    n: jnp.ndarray  # () int32, number of live atoms

    @property
    def capacity(self) -> int:
        return self.mass.shape[0]


def init_atoms(capacity: int) -> AtomTable:
    return AtomTable(
        mass=jnp.zeros((capacity,), jnp.float32),
        elem=jnp.full((capacity,), -1, jnp.int32),
        n=jnp.zeros((), jnp.int32),
    )


def live_cumsum(atoms: AtomTable) -> jnp.ndarray:
    """Inclusive cumsum of the live mask — the per-sweep index structure
    for rank->slot and free-slot queries (one vectorized VPU pass)."""
    return jnp.cumsum((atoms.elem >= 0).astype(jnp.int32))


def rank_to_slot(cum: jnp.ndarray, ranks: jnp.ndarray) -> jnp.ndarray:
    """Slot index of the (rank+1)-th live atom (vectorized binary search).
    Ranks must be < n; uniform ranks => uniform live atoms."""
    return jnp.searchsorted(cum, ranks + 1, side="left").astype(jnp.int32)


def free_rank_to_slot(cum: jnp.ndarray, ranks: jnp.ndarray) -> jnp.ndarray:
    """Slot index of the (rank+1)-th FREE slot (for deterministic birth
    placement). Ranks must be < capacity - n."""
    capacity = cum.shape[0]
    free_cum = jnp.arange(1, capacity + 1, dtype=jnp.int32) - cum
    return jnp.searchsorted(free_cum, ranks + 1, side="left").astype(jnp.int32)


def compact(mass: jnp.ndarray, elem: jnp.ndarray, n_new: jnp.ndarray) -> AtomTable:
    """Stable O(capacity) compaction: live atoms move to slots [0, n)
    preserving order. NOT used in the sweep hot path (holes are allowed);
    kept for checkpoint normalization and tests."""
    capacity = mass.shape[0]
    valid = elem >= 0
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    scat = jnp.where(valid, pos, capacity)  # out-of-bounds => dropped
    new_mass = jnp.zeros_like(mass).at[scat].set(mass, mode="drop")
    new_elem = jnp.full_like(elem, -1).at[scat].set(elem, mode="drop")
    return AtomTable(mass=new_mass, elem=new_elem, n=n_new)


def total_mass_per_element(atoms: AtomTable, n_elements: int) -> jnp.ndarray:
    """Sum of atom masses per matrix element — the debug 'drift' oracle
    (reference: AsynchronousGibbsSampler.h:237-270 maximumDrift)."""
    scat = jnp.where(atoms.elem >= 0, atoms.elem, n_elements)
    return jnp.zeros((n_elements,), jnp.float32).at[scat].add(atoms.mass, mode="drop")
