"""The port's histogram and k-means apps end to end vs the JAX package.

Both packages run the same numpy data, blocked identically (ragged tail
included), over the grid Baseline / SplIter(ppl 1, 2, "auto") /
SplIter(materialize=True) / Rechunk × fusion scan/pallas.  Histograms are
bit-identical; k-means centers agree within the reference's f32 tolerance
and counts exactly; the structural EngineReport columns are equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import blocked as jblocked
from repro.core.apps.histogram import histogram as j_histogram
from repro_torch.core import blocked as tblocked
from repro_torch.core.apps.histogram import histogram as t_histogram

# The apps packages re-export ``kmeans`` the function under the module's name.
jkm = importlib.import_module("repro.core.apps.kmeans")
tkm = importlib.import_module("repro_torch.core.apps.kmeans")

TOL = dict(rtol=2e-5, atol=2e-5)
STRUCTURAL = ("dispatches", "merges", "traces", "bytes_moved", "granularity")
POLICIES = [
    "Baseline()",
    "SplIter(fusion='scan')",
    "SplIter(fusion='pallas')",
    "SplIter(partitions_per_location=2, fusion='scan')",
    "SplIter(partitions_per_location=2, fusion='pallas')",
    "SplIter(partitions_per_location='auto', fusion='scan')",
    "SplIter(partitions_per_location='auto', fusion='pallas')",
    "SplIter(materialize=True)",
    "Rechunk()",
]
# (rows, block_rows, locations): a ragged tail, and a uniform layout.
LAYOUTS = [(97, 12, 3), (96, 8, 4)]


def _policy(api, text):
    return eval(text, {k: getattr(api, k) for k in ("Baseline", "SplIter", "Rechunk")})


def _blocked(pts, rows_per_block, locs):
    jx = jblocked.BlockedArray.from_array(
        jnp.asarray(pts), rows_per_block, num_locations=locs,
        policy=jblocked.round_robin_placement,
    )
    tx = tblocked.BlockedArray.from_blocks(
        [np.asarray(b) for b in jx.blocks], jx.placements, locs, device="cpu"
    )
    return jx, tx


def _structural(report):
    return tuple(getattr(report, f) for f in STRUCTURAL)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"n{l[0]}l{l[2]}")
@pytest.mark.parametrize("pol", POLICIES)
def test_histogram_bit_identical(pol, layout):
    rows, block_rows, locs = layout
    rng = np.random.default_rng(rows)
    pts = rng.uniform(-0.1, 1.1, (rows, 2)).astype(np.float32)
    jx, tx = _blocked(pts, block_rows, locs)
    jh, jrep = j_histogram(jx, bins=4, policy=_policy(japi, pol))
    th, trep = t_histogram(tx, bins=4, policy=_policy(tapi, pol))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert int(th.sum()) == rows
    assert _structural(trep) == _structural(jrep)


def _kmeans_case(seed, k=3, d=3, rows=97, rows_per_block=12, locs=3):
    """Tight blobs around JAX's initial centers, so every iteration's
    assignment is far from a tie and counts can be compared exactly."""
    init = np.asarray(jax.random.uniform(jax.random.key(seed), (k, d), jnp.float32))
    rng = np.random.default_rng(seed)
    means = init + 0.05 * rng.standard_normal((k, d))
    pts = (means[rng.integers(0, k, rows)] + 0.01 * rng.standard_normal((rows, d)))
    jx, tx = _blocked(pts.astype(np.float32), rows_per_block, locs)
    return init, jx, tx


def _use_reference_init(monkeypatch, init):
    monkeypatch.setattr(
        tkm, "_init_centers",
        lambda seed, k, d, dtype, device: torch.tensor(init, dtype=dtype, device=device),
    )


def _partials(api, km, x, centers, policy):
    res = (
        api.Collection.from_blocked(x).split(policy)
        .map_blocks(km.partial_sum_block, extra_args=(centers,))
        .reduce(km._combine)
        .compute()
    )
    return res.value


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"n{l[0]}l{l[2]}")
@pytest.mark.parametrize("pol", POLICIES)
def test_kmeans_matches_reference(pol, layout, monkeypatch):
    rows, block_rows, locs = layout
    init, jx, tx = _kmeans_case(seed=rows, rows=rows, rows_per_block=block_rows, locs=locs)
    _use_reference_init(monkeypatch, init)
    jres = jkm.kmeans(jx, k=3, iters=2, seed=rows, policy=_policy(japi, pol))
    tres = tkm.kmeans(tx, k=3, iters=2, seed=rows, policy=_policy(tapi, pol))
    np.testing.assert_allclose(tres.centers.numpy(), np.asarray(jres.centers), **TOL)
    assert [_structural(r) for r in tres.reports] == [_structural(r) for r in jres.reports]
    # one more step from the converged centers: counts exact, sums close
    c = np.asarray(jres.centers)
    js, jc = _partials(japi, jkm, jx, jnp.asarray(c), _policy(japi, pol))
    ts, tc = _partials(tapi, tkm, tx, torch.tensor(c), _policy(tapi, pol))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_kmeans_init_centers_follow_the_data(monkeypatch):
    """Without the monkeypatch the port draws its own centers from a
    seeded ``torch.Generator`` on the data's device: same seed, same run."""
    _, _, tx = _kmeans_case(seed=1)
    a = tkm.kmeans(tx, k=3, iters=2, seed=1)
    b = tkm.kmeans(tx, k=3, iters=2, seed=1)
    assert a.centers.device == tx.device
    assert torch.equal(a.centers, b.centers)


def test_kmeans_pipeline_equals_barriered_loop(monkeypatch):
    init, _, tx = _kmeans_case(seed=2)
    _use_reference_init(monkeypatch, init)
    ex = tapi.LocalExecutor()
    loop = tkm.kmeans(tx, k=3, iters=3, seed=2, executor=ex)
    piped = tkm.kmeans(tx, k=3, iters=3, seed=2, executor=ex, pipeline=True)
    assert torch.equal(loop.centers, piped.centers)
    assert [r.dispatches for r in piped.reports] == [r.dispatches for r in loop.reports]


def test_persistent_executor_pays_rechunk_once(monkeypatch):
    init, jx, tx = _kmeans_case(seed=3)
    _use_reference_init(monkeypatch, init)
    tres = tkm.kmeans(tx, k=3, iters=3, seed=3, policy=tapi.Rechunk())
    jres = jkm.kmeans(jx, k=3, iters=3, seed=3, policy=japi.Rechunk())
    assert [r.bytes_moved for r in tres.reports] == [r.bytes_moved for r in jres.reports]
    assert tres.reports[0].bytes_moved > 0 and tres.reports[1].bytes_moved == 0


def test_chunk_backed_blocks_match_resident_blocks():
    """Blocks behind an InMemoryStore resolve at dispatch time, same result."""
    pts = np.random.default_rng(4).random((97, 2)).astype(np.float32)
    store = tapi.InMemoryStore()
    tx = tblocked.BlockedArray.from_array(pts, 12, num_locations=3, device="cpu")
    ty = tblocked.BlockedArray.from_array(pts, 12, num_locations=3, device="cpu", store=store)
    assert ty.is_chunked and not tx.is_chunked
    for pol in (tapi.Baseline(), tapi.SplIter(fusion="pallas"), tapi.Rechunk()):
        h, _ = t_histogram(tx, bins=4, policy=pol)
        hc, _ = t_histogram(ty, bins=4, policy=pol)
        assert torch.equal(h, hc)
