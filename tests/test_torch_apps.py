"""The port's four apps end to end vs the JAX package.

Both packages run the same numpy data, blocked identically (ragged tail
included).  Histogram and k-means run over the grid Baseline / SplIter(ppl
1, 2, "auto") / SplIter(materialize=True) / Rechunk × fusion scan/pallas:
histograms are bit-identical; k-means centers agree within the reference's
f32 tolerance and counts exactly; the structural EngineReport columns are
equal.  ``kmeans(seed=s)`` draws the reference's initial centers bit for
bit.  kNN and cascade SVM run under Baseline / SplIter(1, 2) / Rechunk on a
LocalExecutor and a ThreadedExecutor: kNN ids are equal (the data has no
near ties; duplicated fit rows keep ``lax.top_k``'s order) and distances
within 1e-4; the cascade's support vectors are equal and their
coefficients within 1e-4.  Sampled serving gives the reference's tokens.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import blocked as jblocked
from repro.configs import get_smoke_config as j_smoke
from repro.core.apps import cascade_svm as j_svm
from repro.core.apps import knn as j_knn
from repro.core.apps.histogram import histogram as j_histogram
from repro.models import build_model as j_build
from repro.runtime.server import Server as JServer
from repro_torch import _threefry
from repro_torch.configs import get_smoke_config
from repro_torch.core import blocked as tblocked
from repro_torch.core.apps import cascade_svm as t_svm
from repro_torch.core.apps import knn as t_knn
from repro_torch.core.apps.histogram import histogram as t_histogram
from repro_torch.models import params_from_numpy
from repro_torch.runtime import Server

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
def test_kmeans_matches_reference(pol, layout):
    rows, block_rows, locs = layout
    _, jx, tx = _kmeans_case(seed=rows, rows=rows, rows_per_block=block_rows, locs=locs)
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


def test_kmeans_init_centers_follow_the_data():
    """The port draws its centers on the data's device: same seed, same run."""
    _, _, tx = _kmeans_case(seed=1)
    a = tkm.kmeans(tx, k=3, iters=2, seed=1)
    b = tkm.kmeans(tx, k=3, iters=2, seed=1)
    assert a.centers.device == tx.device
    assert torch.equal(a.centers, b.centers)


def test_kmeans_pipeline_equals_barriered_loop():
    _, _, tx = _kmeans_case(seed=2)
    ex = tapi.LocalExecutor()
    loop = tkm.kmeans(tx, k=3, iters=3, seed=2, executor=ex)
    piped = tkm.kmeans(tx, k=3, iters=3, seed=2, executor=ex, pipeline=True)
    assert torch.equal(loop.centers, piped.centers)
    assert [r.dispatches for r in piped.reports] == [r.dispatches for r in loop.reports]


def test_persistent_executor_pays_rechunk_once():
    _, jx, tx = _kmeans_case(seed=3)
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


@pytest.mark.parametrize("seed", [0, 1, 7, 97, -3, 2**31 - 1])
def test_kmeans_seeded_centers_equal_jax(seed):
    """``kmeans(seed=s)`` starts from ``jax.random.uniform(key(s), (k, d))``,
    bit for bit: zero iterations return the initial centers."""
    _, jx, tx = _kmeans_case(seed=1)
    jres = jkm.kmeans(jx, k=3, iters=0, seed=seed)
    tres = tkm.kmeans(tx, k=3, iters=0, seed=seed)
    want = np.asarray(jres.centers)
    np.testing.assert_array_equal(tres.centers.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("pol", ["Baseline()", "SplIter(fusion='pallas')", "Rechunk()"])
def test_kmeans_pipeline_on_threads_equals_barriered_loop(pol):
    """Pipelined k-means on a ThreadedExecutor gives the barriered loop's
    bits, with iterations 2.. overlapped."""
    _, _, tx = _kmeans_case(seed=2)
    policy = _policy(tapi, pol)
    loop = tkm.kmeans(tx, k=3, iters=4, seed=2, policy=policy, executor=tapi.LocalExecutor())
    with tapi.ThreadedExecutor() as ex:
        piped = tkm.kmeans(tx, k=3, iters=4, seed=2, policy=policy, executor=ex, pipeline=True)
        barriered = tkm.kmeans(tx, k=3, iters=4, seed=2, policy=policy, executor=ex)
    assert torch.equal(loop.centers, piped.centers)
    assert torch.equal(loop.centers, barriered.centers)
    assert [r.dispatches for r in piped.reports] == [r.dispatches for r in loop.reports]
    assert [r.overlapped_launches for r in piped.reports][0] == 0
    assert all(r.overlapped_launches > 0 for r in piped.reports[1:])


# -- kNN and cascade SVM (tests/test_core_apps.py) ------------------------------

APP_POLICIES = ["Baseline()", "SplIter()", "SplIter(partitions_per_location=2)", "Rechunk()"]
EXECUTORS = {"local": tapi.LocalExecutor, "threaded": tapi.ThreadedExecutor}
KNN_TOL = dict(rtol=1e-4, atol=1e-4)


def _knn_data(dup: bool = False):
    rng = np.random.default_rng(11)
    fit = rng.normal(size=(300, 3)).astype(np.float32)
    q = rng.normal(size=(64, 3)).astype(np.float32)
    if dup:  # every fit row three times, in different blocks: exact ties
        fit = np.concatenate([fit[:100]] * 3)
    jf, tf = _blocked(fit, 25, 4)
    jq = jblocked.BlockedArray.from_array(jnp.asarray(q), 16, num_locations=4)
    tq = tblocked.BlockedArray.from_blocks(
        [np.asarray(b) for b in jq.blocks], jq.placements, 4, device="cpu")
    return fit, q, jf, tf, jq, tq


def _near_tie_free(fit, q, k):
    """True when no query's k-th and (k+1)-th float64 distances are within 1e-4."""
    d2 = np.sort(((q[:, None, :].astype(np.float64) - fit[None]) ** 2).sum(-1), 1)
    return bool((d2[:, k] - d2[:, k - 1] > 1e-4).all())


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("pol", APP_POLICIES)
def test_knn_matches_reference(pol, executor):
    fit, q, jf, tf, jq, tq = _knn_data()
    assert _near_tie_free(fit, q, 5)
    jr = j_knn(jf, jq, k=5, policy=_policy(japi, pol))
    with EXECUTORS[executor]() as ex:
        tr = t_knn(tf, tq, k=5, policy=_policy(tapi, pol), executor=ex)
    np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))
    np.testing.assert_allclose(tr.distances.numpy(), np.asarray(jr.distances), **KNN_TOL)
    d2 = ((q[:, None, :] - fit[None]) ** 2).sum(-1)
    np.testing.assert_allclose(tr.distances.numpy(), np.sort(d2, 1)[:, :5], **KNN_TOL)
    assert _structural(tr.report) == _structural(jr.report)


@pytest.mark.parametrize("pol", APP_POLICIES)
def test_knn_duplicated_rows_keep_top_k_order(pol):
    """Fit rows repeated three times tie exactly: which copies are kept, and
    in which order, follows ``lax.top_k`` (the lower candidate position
    first) in both packages."""
    _, _, jf, tf, jq, tq = _knn_data(dup=True)
    jr = j_knn(jf, jq, k=5, policy=_policy(japi, pol))
    tr = t_knn(tf, tq, k=5, policy=_policy(tapi, pol))
    d = tr.distances.numpy()
    assert (d[:, 1:] == d[:, :-1]).any()
    np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))


@pytest.fixture(scope="module")
def labeled():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)
    y = np.sign(x @ w + 0.1).astype(np.float32)
    jx, tx = _blocked(x, 32, 4)
    jy, ty = _blocked(y, 32, 4)
    return x, y, jx, tx, jy, ty


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("pol", APP_POLICIES)
def test_cascade_svm_matches_reference(labeled, pol, executor):
    x, y, jx, tx, jy, ty = labeled
    jr = j_svm(jx, jy, num_sv=16, steps=100, iterations=2, policy=_policy(japi, pol))
    with EXECUTORS[executor]() as ex:
        tr = t_svm(tx, ty, num_sv=16, steps=100, iterations=2, policy=_policy(tapi, pol),
                   executor=ex)
    np.testing.assert_array_equal(tr.sv_x.numpy(), np.asarray(jr.sv_x))
    np.testing.assert_array_equal(tr.sv_y.numpy(), np.asarray(jr.sv_y))
    np.testing.assert_allclose(tr.sv_alpha.numpy(), np.asarray(jr.sv_alpha), **KNN_TOL)
    assert _structural(tr.report) == _structural(jr.report)
    for i in range(len(tr.sv_x)):  # every SV is an actual (x, y) pair
        row = np.nonzero((x == tr.sv_x[i].numpy()).all(1))[0]
        assert len(row) >= 1 and y[row[0]] == tr.sv_y[i].item()


def test_cascade_svm_classifies_train_data(labeled):
    x, y, _, tx, _, ty = labeled
    r = t_svm(tx, ty, num_sv=128, steps=300, iterations=2, policy=tapi.SplIter(), c=10.0)
    acc = (np.sign(r.decision(torch.tensor(x)).numpy()) == y).mean()
    assert acc > 0.85, acc


def test_svm_top_k_keeps_lower_index_first_on_ties():
    """Clipped coefficients tie at 0 and c; the support vectors are the
    lower positions among equals, as ``lax.top_k`` picks them."""
    alpha = np.array([0.0, 1.0, 0.5, 1.0, 0.0, 1.0, 0.5, 0.0], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(alpha), 6)[1])
    got = importlib.import_module("repro_torch._topk").top_k(torch.tensor(alpha), 6)[1]
    np.testing.assert_array_equal(got.numpy(), want)


# -- sampled serving -------------------------------------------------------------

NEAR_TIE = 1e-3


def test_sampled_generate_matches_reference():
    """``greedy=False`` draws ``jax.random.categorical(key(i), logits)`` at
    decode step ``i`` in both packages: the port's tokens are the
    categorical draws on its own served logits and equal the reference's
    (except after a near-tie of the Gumbel-perturbed logits)."""
    arch = "qwen3-32b"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    jparams = j_build(jcfg).init(jax.random.key(0))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    jsrv = JServer(jcfg, max_len=40)
    jsrv.load(jparams)
    want, _ = jsrv.generate(prompts, steps=12, greedy=False)
    srv = Server(cfg, max_len=40, device="cpu")
    srv.load(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    got, _, logits = srv.generate(prompts, steps=12, greedy=False, return_logits=True)
    again, _ = srv.generate(prompts, steps=12, greedy=False)
    np.testing.assert_array_equal(got, again)
    assert logits.dtype == torch.float32
    # token t >= 1 is the draw of decode step t - 1 on the logits it served
    for t in range(1, got.shape[1]):
        np.testing.assert_array_equal(
            _threefry.categorical(t - 1, logits[:, t]).numpy(), got[:, t])
    for b in range(got.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:  # after the first near-tie the continuations differ
            t = diff[0]
            assert t > 0
            step = logits[b, t]
            u = _threefry.uniform(t - 1, step.shape, torch.float32,
                                  torch.finfo(torch.float32).tiny, 1.0)
            perturbed = (step - torch.log(-torch.log(u))).numpy()
            assert abs(perturbed[got[b, t]] - perturbed[want[b, t]]) < NEAR_TIE, (b, t)
