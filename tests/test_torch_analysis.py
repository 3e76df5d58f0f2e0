"""The port's ``analysis/`` (``hlo.py``, ``roofline.py``) against the JAX
package's, and the port's collective census.

``tests/test_analysis.py``'s five JAX-free cases run against both packages
(the port's ``analyze`` given the reference's hardware, ``TPU_V5E``); its
case on a real lowering becomes a census case: a ``psum`` on a 1- and a
2-position port mesh, counted by hand.  ``model_flops``, ``_cache_bytes``,
``analyze`` and ``to_markdown`` equal the reference's exactly.
"""

import json
import sys

import numpy as np
import pytest
import torch

from repro.analysis import hlo as ref_hlo
from repro.analysis import roofline as ref_roofline
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro_torch.analysis import hlo, roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed.spmd import P, collective_census, psum, shard_map
from repro_torch.launch.mesh import compat_make_mesh

PACKAGES = {"reference": (ref_hlo, ref_roofline, {}),
            "port": (hlo, roofline, {"hardware": roofline.TPU_V5E})}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    """(hlo module, roofline module, analyze's hardware keyword) of one package."""
    return PACKAGES[request.param]


SYNTH = """
HloModule test

ENTRY main {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ag = f32[128,2048]{1,0} all-gather(%p0), dimensions={1}
  %ar = f32[128,2048]{1,0} all-reduce(%ag), to_apply=add
  %rs = bf16[64,256]{1,0} reduce-scatter(%p0), dimensions={0}
  %cp = f32[128,256]{1,0} collective-permute(%p0), source_target_pairs={{0,1}}
  ROOT %t = (f32[128,2048]{1,0}) tuple(%ar)
}
"""


def test_parse_collectives_counts_and_bytes(pkg):
    st = pkg[0].parse_collectives(SYNTH)
    assert st.counts == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
        "collective-permute": 1,
    }
    p0 = 128 * 256 * 4
    ag = 128 * 2048 * 4
    assert st.operand_bytes["all-gather"] == p0
    assert st.operand_bytes["all-reduce"] == ag
    assert st.operand_bytes["reduce-scatter"] == p0
    assert st.operand_bytes["collective-permute"] == p0
    assert st.result_bytes["reduce-scatter"] == 64 * 256 * 2  # bf16


def _mk(arch="deepseek-7b", shape="train_4k", mesh="single_pod", **kw):
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh, "devices": 256,
        "status": "OK",
        "memory": {"peak_live_bytes": int(10e9)},
        "cost": {"flops": 1e12, "bytes_accessed": 1e11},
        "collectives": {},
    }
    rec.update(kw)
    return rec


def _probe(flops, bytes_, coll, **kw):
    rec = {
        "arch": kw.get("arch", "deepseek-7b"),
        "shape": kw.get("shape", "train_4k"),
        "mesh": kw.get("mesh", "single_pod"),
        "status": "OK",
        "extrapolated": {
            "flops": flops, "bytes_accessed": bytes_,
            "collective_bytes": coll, "collective_by_kind": {},
        },
    }
    return rec


def test_roofline_terms_and_dominance(pkg):
    _, rl, hw = pkg
    rows = rl.analyze([_mk()], [_probe(1.97e14, 8.19e11, 5e10)], **hw)
    r = rows[0]
    np.testing.assert_allclose(r["compute_s"], 1.0)
    np.testing.assert_allclose(r["memory_s"], 1.0)
    np.testing.assert_allclose(r["collective_s"], 1.0)
    assert r["dominant"] in ("compute", "memory", "collective")

    rows = rl.analyze([_mk()], [_probe(1e12, 8.19e13, 5e10)], **hw)
    assert rows[0]["dominant"] == "memory"
    rows = rl.analyze([_mk()], [_probe(1e12, 1e9, 5e13)], **hw)
    assert rows[0]["dominant"] == "collective"


def test_roofline_skip_rows_pass_through(pkg):
    skip = {"arch": "qwen2-72b", "shape": "long_500k", "mesh": "single_pod",
            "status": "SKIP", "reason": "pure full-attention stack"}
    rows = pkg[1].analyze([skip], [], **pkg[2])
    assert rows[0]["status"] == "SKIP"


def test_model_flops_train_vs_decode(pkg):
    tr = pkg[1].model_flops("deepseek-7b", "train_4k")
    de = pkg[1].model_flops("deepseek-7b", "decode_32k")
    # train: 6·N·(256·4096) vs decode: 2·N·128 → ratio = 3·4096·256/128
    np.testing.assert_allclose(tr / de, 3 * 4096 * 256 / 128, rtol=1e-6)


def test_model_flops_moe_uses_active_params(pkg):
    cfg = (ref_get_config if pkg[1] is ref_roofline else get_config)("mixtral-8x7b")
    counts = cfg.param_counts()
    assert counts["active"] < 0.35 * counts["total"]  # 2-of-8 experts
    mf = pkg[1].model_flops("mixtral-8x7b", "train_4k")
    n_eff = counts["active"] - cfg.padded_vocab * cfg.d_model
    np.testing.assert_allclose(mf, 6 * n_eff * 256 * 4096, rtol=1e-6)


# ---------------------------------------------------------------------------
# the census (the reference's real-lowering case)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("positions", [1, 2])
def test_psum_census_counted_by_hand(positions, device):
    """A ``psum`` over an (8, 8) f32 is one all-reduce of 256 bytes in and
    256 out in rank 0's census, whatever the mesh's size: on CPU positions
    (rank threads) and on ``meta`` ones (the shape-only representative)."""
    dev = torch.device(device)
    mesh = compat_make_mesh((positions,), ("data",), devices=(dev,))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8).to(dev)
    with collective_census() as st:
        out = shard_map(lambda v: psum(v, "data"), mesh=mesh, in_specs=(P(),), out_specs=P(),
                        check_vma=False)(x)
    assert hlo.CollectiveStats(**st).as_dict() == {"operand_bytes": {"all-reduce": 256},
                            "result_bytes": {"all-reduce": 256},
                            "counts": {"all-reduce": 1},
                            "total_operand_bytes": 256, "total_result_bytes": 256}
    if device == "cpu":
        assert torch.equal(out, positions * x)
    assert out.shape == (8, 8)


def test_census_records_nothing_outside_its_block():
    mesh = compat_make_mesh((2,), ("data",), devices=(torch.device("cpu"),))
    run = shard_map(lambda v: psum(v, "data"), mesh=mesh, in_specs=(P(),), out_specs=P(),
                    check_vma=False)
    with collective_census() as outer:
        run(torch.ones(4))
        with collective_census() as inner:
            run(torch.ones(4))
    run(torch.ones(4))
    assert outer["counts"] == {"all-reduce": 2} and inner["counts"] == {"all-reduce": 1}


# ---------------------------------------------------------------------------
# exact equality with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_terms_match_reference(arch):
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape) == ref_roofline.model_flops(arch, shape)
        assert roofline._cache_bytes(get_config(arch), SHAPES[shape]) == \
            ref_roofline._cache_bytes(ref_get_config(arch), REF_SHAPES[shape])
        assert roofline._min_bytes_model(arch, shape, 256) == \
            ref_roofline._min_bytes_model(arch, shape, 256)


def _records():
    """Run and probe records over every kind of row ``analyze`` emits."""
    dryrun, probe = [], []
    for i, (arch, shape) in enumerate((a, s) for a in ARCH_IDS for s in SHAPES):
        if shape == "long_500k" and arch in ("qwen2-72b", "qwen3-32b"):
            dryrun.append({"arch": arch, "shape": shape, "mesh": "single_pod",
                           "status": "SKIP", "reason": "pure full-attention stack"})
            continue
        dryrun.append(_mk(arch, shape, devices=256 * (1 + i % 2),
                          memory={"peak_live_bytes": 1e9 * (i + 1)}))
        if i % 7 == 3:
            continue  # no probe: a NO-PROBE row
        scale = 10.0 ** (i % 5 - 2)
        coll = (1e12 if i % 5 == 2 else 1e8) * (i % 3)
        probe.append(_probe(1e15 * scale, 1e12 / scale, coll, arch=arch, shape=shape))
    dryrun.append({"arch": "mamba2-1.3b", "shape": "train_4k", "mesh": "x", "status": "FAIL",
                   "error": "boom"})
    return dryrun, probe


def test_analyze_and_markdown_match_reference():
    dryrun, probe = _records()
    rows = roofline.analyze(dryrun, probe, roofline.TPU_V5E)
    assert rows == ref_roofline.analyze(dryrun, probe)
    assert {r["status"] for r in rows} == {"OK", "SKIP", "NO-PROBE", "FAIL"}
    assert {r.get("dominant") for r in rows} >= {"compute", "memory", "collective"}
    assert roofline.to_markdown(rows) == ref_roofline.to_markdown(rows)
    # the port's default hardware is the H100's: other terms, same shape
    h100 = roofline.analyze(dryrun, probe)
    assert [r["status"] for r in h100] == [r["status"] for r in rows]
    ok = [(a, b) for a, b in zip(h100, rows) if a["status"] == "OK"]
    for a, b in ok:
        assert a["compute_s"] == pytest.approx(b["compute_s"] * 197e12 / 989e12)
        assert a["memory_s"] == pytest.approx(b["memory_s"] * 819e9 / 3.35e12)
        assert a["collective_s"] == pytest.approx(b["collective_s"] * 50e9 / 450e9)


@pytest.mark.parametrize("hardware", sorted(roofline.HARDWARE))
def test_roofline_cli(tmp_path, monkeypatch, capsys, hardware):
    dryrun, probe = _records()
    paths = {}
    for name, data in (("dryrun", dryrun), ("probe", probe)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(data))
    out, md = tmp_path / "rows.json", tmp_path / "rows.md"
    monkeypatch.setattr(sys, "argv", ["roofline", "--dryrun", str(paths["dryrun"]),
                                      "--probe", str(paths["probe"]), "--out", str(out),
                                      "--md", str(md), "--hardware", hardware])
    roofline.main()
    rows = roofline.analyze(dryrun, probe, roofline.HARDWARE[hardware])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    assert md.read_text() == roofline.to_markdown(rows) + "\n"
    assert capsys.readouterr().out.strip() == roofline.to_markdown(rows)
