"""Parity of the PyTorch port's substrate with the JAX package.

The same numpy data is blocked by both packages; the port must produce the
same partitions (ids and item indexes), the same rechunk traffic bill, the
same ragged geometry, and the same bytes — and it must refuse to put data
on the CPU unless asked to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro.core.rechunk import rechunk as jrechunk
from repro.core.spliter import spliter as jspliter
from repro_torch.core import blocked as tblocked
from repro_torch.core.rechunk import rechunk as trechunk
from repro_torch.core.spliter import spliter as tspliter

# (rows, block_rows, locations, placement name) — uniform, ragged tail, ragged
# with many locations, single location, more locations than blocks.
DATASETS = [
    (96, 8, 4, "round_robin_placement"),
    (97, 12, 3, "round_robin_placement"),
    (341, 100, 5, "contiguous_placement"),
    (40, 7, 1, "contiguous_placement"),
    (5, 2, 8, "round_robin_placement"),
]
IDS = [f"n{r}b{b}l{l}" for r, b, l, _ in DATASETS]


def _pair(rows, block_rows, locs, placement, d=3, seed=0):
    pts = np.random.default_rng(seed).normal(size=(rows, d)).astype(np.float32)
    jx = jblocked.BlockedArray.from_array(
        jnp.asarray(pts), block_rows, num_locations=locs,
        policy=getattr(jblocked, placement),
    )
    tx = tblocked.BlockedArray.from_array(
        pts, block_rows, num_locations=locs,
        policy=getattr(tblocked, placement), device="cpu",
    )
    return pts, jx, tx


@pytest.mark.parametrize("ppl", [1, 2, 3])
@pytest.mark.parametrize("ds", DATASETS, ids=IDS)
def test_partitions_match_reference(ds, ppl):
    _, jx, tx = _pair(*ds)
    jparts = jspliter(jx, partitions_per_location=ppl)
    tparts = tspliter(tx, partitions_per_location=ppl)
    assert [(p.location, p.get_indexes()) for p in tparts] == [
        (p.location, p.get_indexes()) for p in jparts
    ]
    for jp, tp in zip(jparts, tparts):
        np.testing.assert_array_equal(tp.get_item_indexes(), jp.get_item_indexes())
        assert tp.num_rows == jp.num_rows
        np.testing.assert_array_equal(tp.materialize().numpy(), np.asarray(jp.materialize()))


@pytest.mark.parametrize("target", [1, 17, 40, 100])
@pytest.mark.parametrize("ds", DATASETS, ids=IDS)
def test_rechunk_bill_matches_reference(ds, target):
    pts, jx, tx = _pair(*ds)
    jy, jstats = jrechunk(jx, target)
    ty, tstats = trechunk(tx, target)
    assert dataclass_tuple(tstats) == dataclass_tuple(jstats)
    assert ty.block_rows == jy.block_rows
    np.testing.assert_array_equal(ty.placements, jy.placements)
    np.testing.assert_array_equal(ty.collect().numpy(), pts)


def dataclass_tuple(stats):
    return (stats.bytes_total, stats.bytes_moved, stats.blocks_before, stats.blocks_after)


@pytest.mark.parametrize("ds", DATASETS, ids=IDS)
def test_geometry_and_ragged_tails_match_reference(ds):
    pts, jx, tx = _pair(*ds)
    assert tx.block_rows == jx.block_rows
    assert tx.num_rows == jx.num_rows == pts.shape[0]
    assert tx.nbytes == jx.nbytes
    assert tx.uniform == jx.uniform
    assert tx.row_shape == tuple(jx.row_shape)
    np.testing.assert_array_equal(tx.row_offsets(), jx.row_offsets())
    for loc in range(jx.num_locations):
        assert tx.blocks_at(loc) == jx.blocks_at(loc)
    np.testing.assert_array_equal(tx.collect().numpy(), pts)


def test_from_array_blocks_are_views():
    x = torch.arange(20.0).reshape(10, 2)
    tx = tblocked.BlockedArray.from_array(x, 4, device="cpu")
    assert all(b.data_ptr() == x[4 * i :].data_ptr() for i, b in enumerate(tx.blocks))
    assert tx.block_rows == (4, 4, 2)


def test_from_blocks_carries_reference_layout():
    """Custom placements and a ragged tail cross over block for block."""
    _, jx, _ = _pair(97, 12, 3, "round_robin_placement")
    custom = np.array([2, 0, 1, 1, 0, 2, 2, 0, 1], np.int32)
    jy = jx.with_placements(custom, 3)
    ty = tblocked.BlockedArray.from_blocks(
        [np.asarray(b) for b in jy.blocks], jy.placements, 3, device="cpu"
    )
    assert ty.block_rows == jy.block_rows
    assert [p.get_indexes() for p in tspliter(ty)] == [
        p.get_indexes() for p in jspliter(jy)
    ]
    for tb, jb in zip(ty.blocks, jy.blocks):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_stacked_requires_uniform_blocks():
    _, _, tx = _pair(96, 8, 4, "round_robin_placement")
    assert tuple(tx.stacked().shape) == (12, 8, 3)
    _, _, ragged = _pair(97, 12, 3, "round_robin_placement")
    with pytest.raises(AssertionError):
        ragged.stacked()


def test_default_device_is_the_card():
    """Without ``device``, construction targets CUDA: on a host without a
    GPU it raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    pts = np.zeros((8, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tblocked.BlockedArray.from_array(pts, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tblocked.BlockedArray.from_blocks([pts], [0], 1)
