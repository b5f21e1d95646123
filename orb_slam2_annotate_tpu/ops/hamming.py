"""Bit-packed Hamming distance between binary descriptor sets.

Replaces ORBmatcher::DescriptorDistance (ORBmatcher.cc:1828, the
bit-twiddling popcount loop) and is the inner kernel of every Search*
routine.  Descriptors are [N, 8] uint32 (256 bits).  The all-pairs
distance matrix is XOR + population_count summed over the words —
elementwise work that XLA fuses into one pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .orb import N_BITS

MAX_DIST = N_BITS  # "unmatched" sentinel (> any real distance after gates)
def hamming_pairwise(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances.

    a: [N, W] u32, b: [M, W] u32 -> [N, M] i32 in [0, 32*W].
    Plain XLA: the fused expression is one memory-bound pass.
    """
    # Word-major accumulation: W fused [N,M] planes instead of an
    # [N,M,W] intermediate with a small minor axis.
    d = jax.lax.population_count(a[:, None, 0] ^ b[None, :, 0])
    for w in range(1, a.shape[-1]):
        d = d + jax.lax.population_count(a[:, None, w] ^ b[None, :, w])
    return d.astype(jnp.int32)


def hamming_rows(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise Hamming distance: a [N,8], b [N,8] -> [N]."""
    return jnp.sum(jax.lax.population_count(a ^ b), axis=-1).astype(jnp.int32)


def masked_min2(dist: jnp.ndarray, mask: jnp.ndarray):
    """Best and second-best along the last axis under a mask.

    dist: [..., M] i32; mask: [..., M] bool (False = exclude).
    Returns (best_val, best_idx, second_val).  Excluded lanes read MAX_DIST.
    """
    d = jnp.where(mask, dist, MAX_DIST)
    best_idx = jnp.argmin(d, axis=-1)
    best_val = jnp.take_along_axis(d, best_idx[..., None], axis=-1)[..., 0]
    d2 = jnp.where(
        jax.nn.one_hot(best_idx, d.shape[-1], dtype=bool), MAX_DIST, d
    )
    second_val = jnp.min(d2, axis=-1)
    return best_val, best_idx, second_val
