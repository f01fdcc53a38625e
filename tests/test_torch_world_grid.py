"""Port vs reference: the WorldGrid allocator (allocate_and_batch).

The port must assign the same slots in the same order, so that every later
comparison can hold pools row for row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg

torch.set_num_threads(1)

FIELDS = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
          "origin_block", "free_stack", "free_count")


def _mask(indices, origin, G=8):
    grid = np.zeros((G, G, G), bool)
    for i in indices:
        grid[tuple(np.asarray(i) - origin)] = True
    return grid, np.asarray(origin, np.int32)


def _both(cfg_kw):
    j = jwg.create_world_grid(jwg.WorldGridConfig(**cfg_kw))
    t = twg.create_world_grid(twg.WorldGridConfig(**cfg_kw), device="cpu")
    return j, t


def _step(j, t, grid, origin, max_blocks):
    j, sj, bj, nj = jwg.allocate_and_batch(
        j, jnp.asarray(grid), jnp.asarray(origin), max_blocks=max_blocks)
    t, st, bt, nt = twg.allocate_and_batch(
        t, torch.from_numpy(grid), torch.from_numpy(origin),
        max_blocks=max_blocks)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert int(nt) == int(nj)
    for f in FIELDS:
        got = getattr(t, f).numpy()
        want = np.asarray(getattr(j, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    return j, t, st.numpy(), int(nt)


def test_allocate_basic_and_idempotent():
    j, t = _both(dict(dims=(16, 16, 16), capacity=64, origin_block=(0, 0, 0)))
    grid, origin = _mask([(1, 2, 3), (4, 5, 6), (7, 0, 1)], (0, 0, 0))
    j, t, slots, n = _step(j, t, grid, origin, 8)
    assert n == 3 and int(t.alloc_count) == 3
    assert np.all(slots[3:] == 64)          # padding slots == capacity
    j, t, _, _ = _step(j, t, grid, origin, 8)
    assert int(t.alloc_count) == 3          # nothing new


def test_out_of_bounds_dropped():
    j, t = _both(dict(dims=(4, 4, 4), capacity=64, origin_block=(0, 0, 0)))
    grid, origin = _mask([(-1, -1, -1), (-2, 0, 0), (1, 1, 1)], (-2, -2, -2))
    j, t, _, _ = _step(j, t, grid, origin, 8)
    assert int(t.alloc_count) == 1
    # A mask that does not overlap the world at all.
    grid, origin = _mask([(20, 20, 20)], (19, 19, 19))
    _step(j, t, grid, origin, 8)


def test_capacity_overflow_counted():
    j, t = _both(dict(dims=(8, 8, 8), capacity=3, origin_block=(0, 0, 0)))
    grid, origin = _mask([(i, k, 0) for i in range(3) for k in range(2)],
                         (0, 0, 0))
    j, t, slots, n = _step(j, t, grid, origin, 8)
    assert int(t.alloc_count) == 3 and int(t.overflow_count) == 3
    assert (slots[:n] < 3).sum() == 3 and (slots[:n] == 3).sum() == 3


def test_batch_clip_counted():
    j, t = _both(dict(dims=(8, 8, 8), capacity=64, origin_block=(0, 0, 0)))
    grid, origin = _mask([(i, k, 0) for i in range(3) for k in range(2)],
                         (0, 0, 0))
    j, t, _, n = _step(j, t, grid, origin, 4)
    assert n == 4 and int(t.alloc_count) == 4 and int(t.overflow_count) == 2


def test_recycling_after_reference_free_slots():
    """Free slots in the reference, load its state, allocate in both: the
    freed slots come back LIFO, then fresh ones."""
    cfg = dict(dims=(16, 16, 16), capacity=64, origin_block=(0, 0, 0))
    j, _ = _both(cfg)
    grid, origin = _mask([(1, 2, 3), (4, 5, 6), (7, 0, 1), (2, 2, 2)],
                         (0, 0, 0))
    j, _, _, _ = jwg.allocate_and_batch(j, jnp.asarray(grid),
                                        jnp.asarray(origin), max_blocks=8)
    j = jwg.free_slots(j, jnp.asarray([1, 3], jnp.int32))
    t = twg.WorldGridState.from_numpy(
        {f: np.asarray(getattr(j, f)) for f in FIELDS}, "cpu")
    np.testing.assert_array_equal(twg.live_slot_mask(t).numpy(),
                                  np.asarray(jwg.live_slot_mask(j)))
    grid, origin = _mask([(4, 5, 6), (2, 2, 2), (9, 9, 9)], (0, 0, 0), G=10)
    j, t, slots, n = _step(j, t, grid, origin, 4)
    # Slots 0..3 went to (1,2,3), (2,2,2), (4,5,6), (7,0,1); 1 and 3 were
    # freed. In scan order (2,2,2) pops 3, (4,5,6) keeps 2, (9,9,9) pops 1.
    assert n == 3 and int(t.free_count) == 0
    assert slots[:3].tolist() == [3, 2, 1]


@pytest.mark.parametrize("seed", [0, 1])
def test_random_masks_sequence(seed):
    """A sequence of random view masks at shifting origins, with pool
    overflow and batch clipping along the way."""
    rng = np.random.RandomState(seed)
    j, t = _both(dict(dims=(12, 10, 8), capacity=300,
                      origin_block=(-6, -5, -2)))
    for _ in range(6):
        grid = rng.rand(9, 9, 9) < 0.15
        origin = rng.randint(-9, 5, 3).astype(np.int32)
        j, t, _, _ = _step(j, t, grid, origin, 128)


def test_neighbours_view_batch_and_ranges_match_reference():
    """neighbor_slots_of / neighbor_slots8_of (world edges included),
    view_batch and allocated_batch_range on a randomly allocated grid."""
    rng = np.random.RandomState(7)
    cfg = dict(dims=(12, 10, 8), capacity=400, origin_block=(-6, -5, -2))
    j, t = _both(cfg)
    for _ in range(3):
        grid = rng.rand(9, 9, 9) < 0.3
        origin = rng.randint(-9, 3, 3).astype(np.int32)
        j, t, _, _ = _step(j, t, grid, origin, 256)
    bidx = np.concatenate([
        np.asarray(j.block_index_of_slot)[:int(j.alloc_count)],
        [[-6, -5, -2], [5, 4, 5], [20, 0, 0]]]).astype(np.int32)
    for jf, tf in ((jwg.neighbor_slots_of, twg.neighbor_slots_of),
                   (jwg.neighbor_slots8_of, twg.neighbor_slots8_of)):
        np.testing.assert_array_equal(
            tf(t, torch.from_numpy(bidx)).numpy(),
            np.asarray(jf(j, jnp.asarray(bidx))))
    for trial in range(3):
        grid = rng.rand(9, 9, 9) < 0.4
        origin = rng.randint(-9, 3, 3).astype(np.int32)
        for mb in (16, 128):
            want = jwg.view_batch(j, jnp.asarray(grid), jnp.asarray(origin),
                                  max_blocks=mb)
            got = twg.view_batch(t, torch.from_numpy(grid),
                                 torch.from_numpy(origin), max_blocks=mb)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for start in (0, 100, 390):
        want = jwg.allocated_batch_range(j, start, max_blocks=64)
        got = twg.allocated_batch_range(t, start, max_blocks=64)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
