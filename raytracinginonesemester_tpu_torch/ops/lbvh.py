"""LBVH construction (Karras 2012) with PyTorch tensor ops.

PyTorch port of ``raytracinginonesemester_tpu.ops.lbvh``, the
reference's flagship structure (``GPUandCPU/include/bvh.h:131-445``,
``bvh.cu:1-318``):

- 30-bit Morton codes by bit expansion (``bvh.h:131-151``);
- 64-bit sort keys ``(morton << 32) | index`` (``bvh.cu:34-56``), held
  in one int64 (non-negative: a Morton code has 30 bits) after a stable
  sort of the codes;
- Karras ``determine_range``/``find_split`` (``bvh.h:163-257``) for every
  internal node at once, as binary searches with the JAX package's fixed
  trip counts;
- the bottom-up refit as a level-synchronous host loop of at most 64
  rounds of "merge children where both are ready".

uint32 values live in int64 tensors, as in ``core.rng``: ``INVALID``
(0xFFFFFFFF) marks a leaf's children and an internal node's object.
Node layout matches the reference (``bvh.h:7-13``, ``bvh.cu:30``):
``2P-1`` nodes, internals at ``[0, P-2]``, leaves at ``[P-1, 2P-2]`` in
Morton order.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Lbvh", "morton_codes", "triangle_aabbs", "build_lbvh", "INVALID"]

INVALID = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Lbvh:
    """Flat LBVH of (2P-1) nodes: ``parent``, ``left``, ``right`` and
    ``object_idx`` int64 holding uint32 values (``INVALID`` for a leaf's
    children and an internal node's object); ``aabb_min``/``aabb_max``
    (2P-1, 3) float32."""

    parent: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    object_idx: torch.Tensor
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor

    @property
    def num_leaves(self) -> int:
        return (int(self.parent.shape[0]) + 1) // 2


def _bit_expand(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (``bitExpansion``, bvh.h:131-138)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, resolution: float = 1024.0) -> torch.Tensor:
    """30-bit Morton codes (int64) of (N, 3) float32 points in the unit
    cube (``ComputeMortonCode``, bvh.h:141-151)."""
    scaled = torch.clamp(points * resolution, 0.0, resolution - 1.0)
    q = scaled.to(torch.int64)  # truncation, as the uint32 cast
    return (_bit_expand(q[..., 0]) * 4 + _bit_expand(q[..., 1]) * 2
            + _bit_expand(q[..., 2]))


def triangle_aabbs(vertices: torch.Tensor):
    """Per-triangle AABBs from (T, 3, 3) vertices (``bvh.h:57-77``)."""
    return vertices.amin(dim=1), vertices.amax(dim=1)


def _clz32_exact(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values (int64 tensor) by the five-step
    bisection of the JAX package, with clz(0) = 32 (``common_upper_bits_cpu``,
    bvh.h:292-301)."""
    n = torch.full_like(x, 32)
    for bits, limit in ((16, 0xFFFF), (8, 0xFF), (4, 0xF), (2, 0x3), (1, 0x1)):
        shift = torch.where(x > limit, bits, 0)
        x, n = x >> shift, n - shift
    return n - x


def _delta_fn(keys: torch.Tensor):
    """delta(i, j): common prefix length of the 64-bit keys ``keys[i]`` and
    ``keys[j]``, -1 for j out of range (``common_upper_bits``,
    bvh.h:163-175): clz of the high words' xor, else 32 + clz of the low
    words'."""
    n = int(keys.shape[0])

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        x = keys[i] ^ keys[torch.clamp(j, 0, n - 1)]
        hi, lo = x >> 32, x & 0xFFFFFFFF
        d = torch.where(hi != 0, _clz32_exact(hi), 32 + _clz32_exact(lo))
        return torch.where(valid, d, -1)

    return delta


def _determine_range(delta, n: int, idx: torch.Tensor):
    """``determine_range`` (bvh.h:178-236) of every internal node: the
    direction from the neighbours' deltas, a doubling upper bound, then
    a binary search, each with the JAX package's trip count."""
    l_delta = delta(idx, idx - 1)
    r_delta = delta(idx, idx + 1)
    d = torch.where(r_delta > l_delta, 1, -1)
    delta_min = torch.minimum(l_delta, r_delta)
    max_rounds = max(2, (n - 1).bit_length() + 1)

    l_max = torch.full_like(idx, 2)
    for _ in range(max_rounds):
        grow = delta(idx, idx + d * l_max) > delta_min
        l_max = torch.where(grow, l_max << 1, l_max)

    l = torch.zeros_like(idx)
    t = l_max >> 1
    for _ in range(max_rounds):
        probe = delta(idx, idx + (l + t) * d) > delta_min
        l = torch.where((t > 0) & probe, l + t, l)
        t = t >> 1
    jdx = idx + l * d
    return torch.minimum(idx, jdx), torch.maximum(idx, jdx)


def _find_split(delta, first: torch.Tensor, last: torch.Tensor):
    """``find_split`` (bvh.h:239-257): the highest-differing-bit split,
    33 halvings of the stride.  The 64-bit keys are unique, so the
    reference's equal-codes midpoint is never needed."""
    delta_node = delta(first, last)
    split = first.clone()
    stride = last - first
    for _ in range(33):
        stride = (stride + 1) >> 1
        middle = split + stride
        ok = (middle < last) & (delta(first, middle) > delta_node)
        split = torch.where(ok, middle, split)
    return split


def build_lbvh(vertices: torch.Tensor) -> Lbvh:
    """Build the LBVH of (T, 3, 3) float32 triangles on their device:
    leaf AABBs -> scene AABB -> Morton keys -> stable sort -> Karras
    topology -> refit (``buildBVH``, bvh.cu:93-206).  The tree equals the
    JAX package's ``build_lbvh`` exactly."""
    p = int(vertices.shape[0])
    if p < 2:
        raise ValueError("LBVH needs at least 2 primitives")
    dev = vertices.device
    leaf_min, leaf_max = triangle_aabbs(vertices)
    scene_min = leaf_min.amin(dim=0)
    scene_max = leaf_max.amax(dim=0)
    extent = scene_max - scene_min
    norm = (0.5 * (leaf_min + leaf_max) - scene_min) / torch.where(
        extent == 0, torch.ones_like(extent), extent)
    codes = morton_codes(norm)

    codes_sorted, order = torch.sort(codes, stable=True)
    keys = (codes_sorted << 32) | order  # the original index is the low word
    delta = _delta_fn(keys)

    idx = torch.arange(p - 1, dtype=torch.int64, device=dev)
    first, last = _determine_range(delta, p, idx)
    first[0] = 0  # the root covers the whole range (bvh.h:183-186)
    last[0] = p - 1
    gamma = _find_split(delta, first, last)
    # children that are range endpoints are leaves, offset by P-1
    # (bvh.h:273-280)
    left = torch.where(first == gamma, gamma + (p - 1), gamma)
    right = torch.where(last == gamma + 1, gamma + p, gamma + 1)

    invalid = torch.full((p,), INVALID, dtype=torch.int64, device=dev)
    node_left = torch.cat([left, invalid])
    node_right = torch.cat([right, invalid])
    node_obj = torch.cat([invalid[:p - 1], order])
    parent = torch.zeros(2 * p - 1, dtype=torch.int64, device=dev)
    parent[left] = idx
    parent[right] = idx

    inf = float("inf")
    aabb_min = torch.cat([torch.full((p - 1, 3), inf, device=dev),
                          leaf_min[order]])
    aabb_max = torch.cat([torch.full((p - 1, 3), -inf, device=dev),
                          leaf_max[order]])
    ready = torch.cat([torch.zeros(p - 1, dtype=torch.bool, device=dev),
                       torch.ones(p, dtype=torch.bool, device=dev)])
    for _ in range(64):  # the radix tree of 64-bit keys is <= 64 deep
        can = ready[left] & ready[right] & ~ready[:p - 1]
        if not bool(can.any()):
            break
        aabb_min[:p - 1] = torch.where(
            can[:, None], torch.minimum(aabb_min[left], aabb_min[right]),
            aabb_min[:p - 1])
        aabb_max[:p - 1] = torch.where(
            can[:, None], torch.maximum(aabb_max[left], aabb_max[right]),
            aabb_max[:p - 1])
        ready[:p - 1] |= can
    return Lbvh(parent=parent, left=node_left, right=node_right,
                object_idx=node_obj, aabb_min=aabb_min, aabb_max=aabb_max)
