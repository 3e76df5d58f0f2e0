"""The port's trainer, data pipeline and FT machinery on the CPU, alone and
against the JAX package.

The trainer, pipeline and FT cases of ``tests/test_runtime.py`` run on the
port (``device="cpu"``; the preemption is driven by ``request_stop``, never
a clock).  Against the JAX package (``JAX_PLATFORMS=cpu``), on the same
numpy inputs:

* the pipeline's batches, byte for byte, also after a resume;
* ``Trainer.train_step`` in each mode from the same params (the JAX
  params through ``params_from_numpy(master=True)``): losses within 1e-5
  relative in f32, dispatch counts equal, and the first step moves no
  weight (its learning rate is 0, as the reference reads it);
* a 10-step loss curve in each mode within 1e-5 relative in f32;
* checkpoints across packages: ``(params, AdamWState)`` flattens to the
  reference's manifest paths (``.step``, ``.m/…``, ``.v/…``), a JAX
  trainer's checkpoint (lm1m, preempted at step 6) resumes in the port to
  step 12 with the loss tail within 1e-3 relative (bf16 compute, as the
  preset runs), and ``launch/serve.py --ckpt-dir`` serves a port trainer's
  params.
"""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import repro.data as jdata
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.launch.train import _preset as j_preset
from repro.runtime.ft import PreemptionGuard as JGuard
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch._pytree import tree_leaves
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data import BlockedBatchPipeline, SyntheticTextDataset, synthetic_lm_batch
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import _preset
from repro_torch.models import params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.runtime import Server, TrainConfig, Trainer
from repro_torch.runtime.ft import HeartbeatMonitor, PreemptionGuard, StragglerDetector

MODES = ("spliter", "per_block", "materialized")
DISPATCHES = {"spliter": 1, "per_block": 3, "materialized": 1}  # 2 blocks
#: the port's loss against the JAX package's, f32 (measured: under 2e-7)
F32_LOSS_RTOL = 1e-5
#: a resumed bf16 lm1m run's losses against the JAX run's (measured: 1.3e-4)
BF16_RESUME_RTOL = 1e-3


def _cfg(**kw) -> TrainConfig:
    base = dict(global_batch=8, num_blocks=2, seq_len=32, steps=10,
                peak_lr=1e-3, warmup_steps=2)
    base.update(kw)
    return TrainConfig(**base)


def _jcfg(**kw) -> JTrainConfig:
    return JTrainConfig(**dataclasses.asdict(_cfg(**kw)))


def _to_port(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _jax_order(tree):
    """A port tree's leaves in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jax_order(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _jax_order(t)]
    return [tree]


# ---------------------------------------------------------------------------
# tests/test_runtime.py on the port
# ---------------------------------------------------------------------------


def test_trainer_loss_decreases():
    tr = Trainer(_preset("lm1m"), _cfg(steps=20), device="cpu")
    out = tr.run(resume=False)
    first = np.mean(out["losses"][:4])
    last = np.mean(out["losses"][-4:])
    assert last < first, (first, last)
    assert out["dispatches"] == 20  # spliter: ONE dispatch per step


def test_preemption_resume_bit_identical(tmp_path):
    """Uninterrupted run == (run-to-preemption; restart; finish), exactly."""
    mc = _preset("lm1m")
    full = Trainer(mc, _cfg(steps=12), device="cpu").run(resume=False)

    ck = str(tmp_path / "ck")
    t1 = Trainer(mc, _cfg(steps=12, ckpt_dir=ck), device="cpu")
    guard = PreemptionGuard(install=False)

    def stop_at_6(step, loss):
        if step == 5:
            guard.request_stop()

    out1 = t1.run(guard=guard, on_step=stop_at_6)
    assert out1["preempted"] and out1["stopped_at"] == 6

    t2 = Trainer(mc, _cfg(steps=12, ckpt_dir=ck), device="cpu")
    out2 = t2.run(resume=True)
    assert out2["stopped_at"] == 12

    for a, b in zip(tree_leaves((full["params"], full["opt"])),
                    tree_leaves((out2["params"], out2["opt"]))):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(full["losses"][6:], out2["losses"])


def test_checkpointer_atomic_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(8.0)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree, extras={"s": s}, blocking=True)
    ck.keep_last(2)
    assert ck.latest_step() == 4
    steps = sorted(int(f[5:-10]) for f in os.listdir(tmp_path) if f.endswith(".COMMITTED"))
    assert steps == [3, 4]
    os.makedirs(tmp_path / "step_000000099")  # uncommitted (a crash) is ignored
    assert ck.latest_step() == 4


def test_pipeline_deterministic_and_resumable():
    kw = dict(vocab_size=128, seq_len=16, global_batch=8, num_blocks=2, seed=3)
    p1 = BlockedBatchPipeline(**kw)
    it = iter(p1)
    batches = [next(it) for _ in range(5)]
    p1.close()
    np.testing.assert_array_equal(batches[3]["tokens"], p1.peek(3)["tokens"])
    p2 = BlockedBatchPipeline(**kw)
    p2.state.step = 3
    it2 = iter(p2)
    np.testing.assert_array_equal(next(it2)["tokens"], batches[3]["tokens"])
    np.testing.assert_array_equal(next(it2)["labels"], batches[4]["labels"])
    p2.close()
    b = batches[0]
    np.testing.assert_array_equal(b["tokens"][:, :, 1:], b["labels"][:, :, :-1])


def test_pipeline_reiteration_does_not_leak_threads():
    base = threading.active_count()
    p = BlockedBatchPipeline(vocab_size=128, seq_len=16, global_batch=8, num_blocks=2, seed=3)
    first = next(iter(p))
    for _ in range(3):  # each re-entry must retire the previous worker
        next(iter(p))
    assert threading.active_count() <= base + 1
    np.testing.assert_array_equal(first["tokens"], p.peek(0)["tokens"])
    p.close()
    p.close()  # idempotent
    assert threading.active_count() == base


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(["w0", "w1"], timeout=10.0)
    hb.beat("w0", now=100.0)
    hb.beat("w1", now=100.0)
    assert hb.dead_workers(now=105.0) == []
    hb.beat("w0", now=115.0)
    assert hb.dead_workers(now=115.0) == ["w1"]


def test_straggler_detector_and_resplit_weights():
    sd = StragglerDetector(["w0", "w1", "w2"], threshold=1.5, patience=2)
    v = sd.record_step({"w0": 1.0, "w1": 1.0, "w2": 2.0})
    assert not v.is_straggler
    v = sd.record_step({"w0": 1.0, "w1": 1.0, "w2": 2.2})
    assert v.is_straggler and v.worker == "w2"
    w = sd.capacity_weights(["w0", "w1", "w2"])
    assert w["w2"] < w["w0"]
    assert abs(sum(w.values()) - 3.0) < 1e-6


def test_trainer_records_each_step_with_the_straggler_detector():
    tr = Trainer(_preset("lm1m"), _cfg(steps=3), device="cpu")
    tr.run(resume=False)
    assert len(tr.straggler.history["self"]) == 3


# ---------------------------------------------------------------------------
# data: byte for byte against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_batches_equal_reference_byte_for_byte(seed):
    kw = dict(vocab_size=300, seq_len=24, global_batch=6, num_blocks=3, seed=seed)
    jp, tp = jdata.BlockedBatchPipeline(**kw), BlockedBatchPipeline(**kw)
    jit, tit = iter(jp), iter(tp)
    for _ in range(4):
        a, b = next(jit), next(tit)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    jp.close()
    tp.close()
    # after a resume at the cursor both stopped at
    assert jp.state.to_json() == tp.state.to_json()
    jr = jdata.BlockedBatchPipeline(**kw, state=jdata.PipelineState.from_json(jp.state.to_json()))
    tr = BlockedBatchPipeline(**kw, state=type(tp.state).from_json(tp.state.to_json()))
    a, b = next(iter(jr)), next(iter(tr))
    jr.close()
    tr.close()
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert tp.peek(9)["tokens"].tobytes() == jp.peek(9)["tokens"].tobytes()


def test_synthetic_batches_equal_reference():
    a = jdata.synthetic_lm_batch(97, 4, 10, seed=2, step=5)
    b = synthetic_lm_batch(97, 4, 10, seed=2, step=5)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert (SyntheticTextDataset(97, 11, 2).document(7).tobytes()
            == jdata.SyntheticTextDataset(97, 11, 2).document(7).tobytes())


# ---------------------------------------------------------------------------
# the trainer against the JAX package
# ---------------------------------------------------------------------------


def _pair(mode, dtype="float32", **kw):
    """(JAX trainer, its initial (params, opt), port trainer, the same state)."""
    jmc = dataclasses.replace(j_preset("lm1m"), dtype=dtype)
    jt = JTrainer(jmc, _jcfg(accum_mode=mode, **kw))
    jp, jo = jt.init_state()
    tt = Trainer(_to_port(jmc), _cfg(accum_mode=mode, **kw), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tt.model_cfg, device="cpu",
                           master=True)
    return jt, (jp, jo), tt, (tp, adamw_init(tp))


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_reference(mode):
    jt, (jp, jo), tt, (tp, to) = _pair(mode)
    before = [t.clone() for t in _jax_order(tp)]
    assert all(t.dtype == torch.float32 for t in before)  # f32 master weights
    blocks = jt.pipeline.peek(0)
    jp, jo, jl, jn = jt.train_step(jp, jo, blocks)
    tp, to, tl, tn = tt.train_step(tp, to, blocks)
    assert tn == jn == DISPATCHES[mode]
    assert tl.dtype == torch.float32 and not tl.requires_grad
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_LOSS_RTOL)
    # step 1's learning rate is cosine_schedule(0) = 0: no weight moves (decay too)
    assert int(to.step) == int(jo.step) == 1
    for a, b, c in zip(_jax_order(tp), before, jax.tree.leaves(jp)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    for a, b in zip(_jax_order(to.m), jax.tree.leaves(jo.m)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_ten_step_loss_curve_matches_reference(mode):
    jt, (jp, jo), tt, (tp, to) = _pair(mode)
    jl, tl = [], []
    for s in range(10):
        blocks = jt.pipeline.peek(s)
        jp, jo, loss, _ = jt.train_step(jp, jo, blocks)
        jl.append(float(loss))
        tp, to, loss, _ = tt.train_step(tp, to, blocks)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=F32_LOSS_RTOL)
    assert np.mean(tl[-3:]) < np.mean(tl[:3])


def test_unknown_mode_raises():
    tt = Trainer(_preset("lm1m"), _cfg(accum_mode="bogus"), device="cpu")
    p, o = tt.init_state()
    with pytest.raises(ValueError, match="bogus"):
        tt.train_step(p, o, tt.pipeline.peek(0))


# ---------------------------------------------------------------------------
# checkpoints across packages; serve --ckpt-dir
# ---------------------------------------------------------------------------


def test_state_flattens_to_the_reference_paths(tmp_path):
    jm = dataclasses.replace(j_preset("lm1m"), dtype="float32")
    jt = JTrainer(jm, _jcfg())
    jstate = jt.init_state()
    JCheckpointer(str(tmp_path / "j")).save(1, jstate)
    tt = Trainer(_to_port(jm), _cfg(), device="cpu")
    Checkpointer(str(tmp_path / "t")).save(1, tt.init_state())
    jman = json.load(open(tmp_path / "j" / "step_000000001" / "MANIFEST.json"))
    tman = json.load(open(tmp_path / "t" / "step_000000001" / "MANIFEST.json"))
    assert tman["paths"] == jman["paths"]
    assert {"1/.step", "1/.m/embed", "1/.v/final_norm"} <= set(tman["paths"])
    assert [m["shape"] for m in tman["leaves"]] == [m["shape"] for m in jman["leaves"]]
    assert [m["dtype"] for m in tman["leaves"]] == [m["dtype"] for m in jman["leaves"]]


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX trainer runs lm1m to step 6 and is preempted; the port
    restores ``(params, opt)`` from its checkpoint and finishes to step 12.
    Its losses are the uninterrupted JAX run's within BF16_RESUME_RTOL."""
    jmc = j_preset("lm1m")
    full = JTrainer(jmc, _jcfg(steps=12)).run(resume=False)
    ck = str(tmp_path / "ck")
    guard = JGuard(install=False)

    def stop_at_6(step, loss):
        if step == 5:
            guard.request_stop()

    out1 = JTrainer(jmc, _jcfg(steps=12, ckpt_dir=ck)).run(guard=guard, on_step=stop_at_6)
    assert out1["stopped_at"] == 6
    tt = Trainer(_to_port(jmc), _cfg(steps=12, ckpt_dir=ck), device="cpu")
    template = tt.init_state()
    manifest, step = tt.ckpt.load_manifest()
    flat = Checkpointer(str(tmp_path / "t"))
    flat.save(step, template)
    assert flat.load_manifest()[0]["paths"] == manifest["paths"]
    (params, opt), extras, _ = tt.ckpt.restore(template)
    for a, b in zip(_jax_order(params), jax.tree.leaves(out1["params"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(opt.step) == 6
    out2 = tt.run(resume=True)
    assert out2["stopped_at"] == 12 and len(out2["losses"]) == 6
    np.testing.assert_allclose(out2["losses"], full["losses"][6:], rtol=BF16_RESUME_RTOL)


def test_serve_restores_a_trainer_checkpoint(tmp_path, capsys):
    """``--ckpt-dir`` serves the trained params: the greedy tokens equal
    those of a server loaded with the trainer's params directly."""
    from repro_torch.configs import get_smoke_config

    mc = get_smoke_config("qwen3-32b")
    ck = str(tmp_path / "ck")
    out = Trainer(mc, _cfg(steps=3, ckpt_every=3, ckpt_dir=ck), device="cpu").run(resume=False)
    serve_cli.main(["--arch", "qwen3-32b", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--steps", "4", "--ckpt-dir", ck])
    printed = capsys.readouterr().out
    assert "restored step 3" in printed
    served = json.loads(printed.split("first request's tokens:")[1].strip())

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, mc.vocab_size, (2, 8), dtype=np.int32)
    srv = Server(mc, max_len=128, device="cpu")
    srv.load(out["params"])
    toks, _ = srv.generate(prompts, steps=4)
    assert served == toks[0].tolist()
    restored, step = serve_cli.restore_params(ck, Trainer(mc, _cfg(), device="cpu").init_state()[0])
    assert step == 3
    for a, b in zip(tree_leaves(restored), tree_leaves(out["params"])):
        assert a.dtype == torch.float32 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------


def test_train_cli_preset_on_the_cpu(tmp_path, capsys):
    out_json = str(tmp_path / "curve.json")
    train_cli.main(["--preset", "lm1m", "--device", "cpu", "--steps", "3", "--global-batch",
                    "4", "--num-blocks", "2", "--seq-len", "16", "--log-every", "1",
                    "--accum-mode", "per_block", "--out-json", out_json])
    printed = capsys.readouterr().out
    assert "model=lm1m" in printed and "mode=per_block" in printed
    assert "step     3  loss" in printed and "done: steps=3  dispatches=9" in printed
    curve = json.load(open(out_json))
    assert curve["model"] == "lm1m" and len(curve["losses"]) == 3 and curve["dispatches"] == 9


def test_train_cli_arch_requires_smoke():
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "qwen3-32b", "--device", "cpu"])


@pytest.mark.parametrize("name", ["lm1m", "lm20m", "lm100m"])
def test_presets_have_the_reference_widths(name):
    assert dataclasses.asdict(_preset(name)) == dataclasses.asdict(j_preset(name))
