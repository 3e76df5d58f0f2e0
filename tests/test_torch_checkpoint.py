"""The port's Checkpointer against ``tests/test_checkpoint.py`` and the JAX one.

Every case of the reference's crash-mid-save, ``load_manifest`` and
retention tests runs here on tensor trees.  Then the two packages read
each other's checkpoints: a step either one wrote restores in the other
(same layout, same leaf order, dict keys sorted as ``jax.tree_util``
sorts them), their manifests agree, a bf16 leaf is written with the bytes
the JAX package writes for one (its 16-bit patterns as ``'<V2'``), and
restore puts each leaf on the template leaf's device and dtype.  Values
compare exactly: a checkpoint is a copy.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch.checkpoint import Checkpointer


def _tree(value: float):
    return {"w": torch.full((4, 2), value), "b": torch.full((2,), value)}


def _jtree(value: float):
    return {"w": jnp.full((4, 2), value), "b": jnp.full((2,), value)}


def _save(ckpt: Checkpointer, step: int, value: float, **extras):
    ckpt.save(step, _tree(value), extras=dict(extras) or None)


class TestCrashMidSave:
    def test_tmp_dir_without_commit_is_skipped(self, tmp_path):
        root = str(tmp_path)
        ckpt = Checkpointer(root)
        _save(ckpt, 1, 1.0)
        tmp = os.path.join(root, "step_000000002.tmp")
        os.makedirs(tmp)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"step": 2, "extras": {"poison": True}}, f)
        assert ckpt.latest_step() == 1
        tree, extras, step = ckpt.restore(_tree(0.0))
        assert step == 1
        assert torch.equal(tree["w"], torch.full((4, 2), 1.0))

    def test_renamed_dir_without_marker_is_skipped(self, tmp_path):
        root = str(tmp_path)
        ckpt = Checkpointer(root)
        _save(ckpt, 1, 1.0)
        _save(ckpt, 2, 2.0)
        os.remove(os.path.join(root, "step_000000002.COMMITTED"))
        assert ckpt.latest_step() == 1
        _, _, step = ckpt.restore(_tree(0.0))
        assert step == 1

    def test_newest_committed_step_wins(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        for step, value in ((1, 1.0), (5, 5.0), (3, 3.0)):
            _save(ckpt, step, value)
        assert ckpt.latest_step() == 5
        tree, _, step = ckpt.restore(_tree(0.0))
        assert step == 5
        assert torch.equal(tree["b"], torch.full((2,), 5.0))

    def test_restore_explicit_step_requires_its_marker(self, tmp_path):
        root = str(tmp_path)
        ckpt = Checkpointer(root)
        _save(ckpt, 1, 1.0)
        _save(ckpt, 2, 2.0)
        os.remove(os.path.join(root, "step_000000002.COMMITTED"))
        with pytest.raises(AssertionError, match="uncommitted"):
            ckpt.restore(_tree(0.0), step=2)

    def test_empty_root_has_no_checkpoint(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        assert ckpt.latest_step() is None
        with pytest.raises(AssertionError, match="no committed checkpoint"):
            ckpt.restore(_tree(0.0))


class TestLoadManifest:
    def test_reads_extras_without_template(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        _save(ckpt, 7, 1.0, tenant_pass={"alice": 2.5}, jobs=3)
        manifest, step = ckpt.load_manifest()
        assert step == 7
        assert manifest["extras"] == {"tenant_pass": {"alice": 2.5}, "jobs": 3}
        assert len(manifest["leaves"]) == 2

    def test_zero_leaf_snapshot_round_trips(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, {}, extras={"state": [1, 2, 3]})
        manifest, step = ckpt.load_manifest()
        assert (manifest["extras"]["state"], step) == ([1, 2, 3], 1)
        assert manifest["leaves"] == []

    def test_skips_uncommitted_and_raises_when_none(self, tmp_path):
        root = str(tmp_path)
        ckpt = Checkpointer(root)
        with pytest.raises(FileNotFoundError):
            ckpt.load_manifest()
        _save(ckpt, 2, 2.0, marker="good")
        _save(ckpt, 4, 4.0, marker="uncommitted")
        os.remove(os.path.join(root, "step_000000004.COMMITTED"))
        manifest, step = ckpt.load_manifest()
        assert (step, manifest["extras"]["marker"]) == (2, "good")


class TestRetention:
    def test_keep_last_drops_old_committed_steps(self, tmp_path):
        root = str(tmp_path)
        ckpt = Checkpointer(root)
        for step in (1, 2, 3, 4):
            _save(ckpt, step, float(step))
        ckpt.keep_last(2)
        assert sorted(
            int(f[len("step_"):-len(".COMMITTED")])
            for f in os.listdir(root)
            if f.endswith(".COMMITTED")
        ) == [3, 4]
        assert not os.path.exists(os.path.join(root, "step_000000001"))
        _, _, step = ckpt.restore(_tree(0.0))
        assert step == 4

    def test_keep_last_ignores_uncommitted_junk(self, tmp_path):
        root = str(tmp_path)
        ckpt = Checkpointer(root)
        _save(ckpt, 1, 1.0)
        os.makedirs(os.path.join(root, "step_000000009.tmp"))
        ckpt.keep_last(1)
        assert ckpt.latest_step() == 1


# ---------------------------------------------------------------------------
# beyond the reference's cases: async saves, nested trees, devices, dtypes
# ---------------------------------------------------------------------------


def _nested(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {
        "layers": [
            {"w": torch.randn(3, 4, generator=g), "n": torch.arange(4, dtype=torch.int32)},
            {"w": torch.randn(3, 4, generator=g), "n": torch.arange(4, dtype=torch.int32) * 2},
        ],
        "emb": (torch.randn(5, generator=g).to(torch.bfloat16), torch.tensor(7, dtype=torch.int64)),
        "a": torch.randn(2, 2, generator=g, dtype=torch.float64),
    }


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _assert_trees_equal(u, v)
    else:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


@pytest.mark.parametrize("blocking", [True, False])
def test_nested_tree_round_trips_exactly(tmp_path, blocking):
    ckpt = Checkpointer(str(tmp_path))
    tree = _nested(0)
    ckpt.save(1, tree, blocking=blocking, extras={"k": 1})
    # the host snapshot was taken before save returned: mutation is safe
    tree["a"].add_(100.0)
    ckpt.wait()
    got, extras, step = ckpt.restore(_zeros_like(tree))
    want = _nested(0)
    _assert_trees_equal(got, want)
    assert (extras, step) == ({"k": 1}, 1)


def test_restore_follows_the_template_leaf_dtype(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)})
    got, _, _ = ckpt.restore({"w": torch.zeros(2, 3, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float64).reshape(2, 3))


def test_restore_puts_leaves_on_the_template_device(tmp_path):
    """A CUDA template leaf gets a CUDA leaf back (the counterpart of the
    reference's ``device_put``); on a host without a card, the CPU."""
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.ones(3)})
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    got, _, _ = ckpt.restore({"w": torch.zeros(3, device=dev)})
    assert got["w"].device == dev and torch.equal(got["w"].cpu(), torch.ones(3))


def test_shape_mismatch_is_refused(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"w": torch.ones(3)})
    with pytest.raises(AssertionError):
        ckpt.restore({"w": torch.zeros(4)})


# ---------------------------------------------------------------------------
# cross-reads with the JAX package
# ---------------------------------------------------------------------------


def test_reference_reads_port_checkpoint(tmp_path):
    Checkpointer(str(tmp_path)).save(3, _tree(2.5), extras={"who": "port"})
    jc = JCheckpointer(str(tmp_path))
    tree, extras, step = jc.restore(_jtree(0.0))
    assert (extras, step) == ({"who": "port"}, 3)
    np.testing.assert_array_equal(np.asarray(tree["w"]), np.full((4, 2), 2.5, np.float32))
    np.testing.assert_array_equal(np.asarray(tree["b"]), np.full((2,), 2.5, np.float32))
    manifest, _ = jc.load_manifest()
    assert manifest["paths"] == ["b", "w"]


def test_port_reads_reference_checkpoint(tmp_path):
    JCheckpointer(str(tmp_path)).save(4, _jtree(1.5), extras={"who": "jax"})
    tree, extras, step = Checkpointer(str(tmp_path)).restore(_tree(0.0))
    assert (extras, step) == ({"who": "jax"}, 4)
    assert torch.equal(tree["w"], torch.full((4, 2), 1.5))
    assert torch.equal(tree["b"], torch.full((2,), 1.5))


def test_manifests_and_leaf_files_agree(tmp_path):
    """Same tree through both packages: the same paths, leaf shapes and
    dtypes, and leaf files byte for byte — a bf16 leaf included."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    e = rng.normal(size=(6,)).astype(np.float32)
    n = np.arange(5, dtype=np.int32)
    t_tree = {"z": [torch.from_numpy(w), {"n": torch.from_numpy(n)}],
              "e": torch.from_numpy(e).to(torch.bfloat16)}
    j_tree = {"z": [jnp.asarray(w), {"n": jnp.asarray(n)}],
              "e": jnp.asarray(e).astype(jnp.bfloat16)}
    Checkpointer(str(tmp_path / "t")).save(1, t_tree)
    JCheckpointer(str(tmp_path / "j")).save(1, j_tree)
    tm, _ = Checkpointer(str(tmp_path / "t")).load_manifest()
    jm, _ = JCheckpointer(str(tmp_path / "j")).load_manifest()
    assert tm["paths"] == jm["paths"] == ["e", "z/0", "z/1/n"]
    assert tm["leaves"] == jm["leaves"]
    assert tm["leaves"][0]["dtype"] == "bfloat16"
    for i in range(3):
        name = f"step_000000001/leaf_{i:05d}.npy"
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_port_restores_reference_bf16_leaf(tmp_path):
    """The reference writes a bf16 leaf as its 16-bit patterns (``'<V2'``)
    and cannot cast it back itself; the port restores it exactly."""
    e = np.random.default_rng(1).normal(size=(8,)).astype(np.float32)
    JCheckpointer(str(tmp_path)).save(1, {"e": jnp.asarray(e).astype(jnp.bfloat16)})
    tree, _, _ = Checkpointer(str(tmp_path)).restore(
        {"e": torch.zeros(8, dtype=torch.bfloat16)})
    assert torch.equal(tree["e"], torch.from_numpy(e).to(torch.bfloat16))


def test_reference_retention_and_markers_hold_on_port_steps(tmp_path):
    """Port-written steps follow the marker layout the reference scans."""
    ckpt = Checkpointer(str(tmp_path))
    for step in (1, 2, 3):
        _save(ckpt, step, float(step))
    os.remove(os.path.join(str(tmp_path), "step_000000003.COMMITTED"))
    jc = JCheckpointer(str(tmp_path))
    assert jc.latest_step() == 2
    jc.keep_last(1)
    assert ckpt.latest_step() == 2
    tree, _, _ = ckpt.restore(_tree(0.0))
    assert torch.equal(tree["w"], torch.full((4, 2), 2.0))
