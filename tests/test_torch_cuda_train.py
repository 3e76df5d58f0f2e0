"""The port's trainer on the card against the same trainer on the CPU.

Needs an NVIDIA GPU; on a host without one every test skips with that
reason.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

lm1m in f32 with ``attn_impl="flash"``: one ``Trainer.train_step`` in each
mode on the card from the CPU's initial params (moved), against the same
step on the CPU: three steps' losses within ``LOSS_RTOL``, every param and
moment after the first within ``STATE_GAP`` (TF32 off: f32 sums in another
order), the dispatch
counts equal, and neither the flash kernel nor ``ssd_scan`` launched (under
autograd the model takes the plain routes).  Resume on the card: a run
preempted at step 6 (``PreemptionGuard.request_stop``), restored and
finished equals an uninterrupted run bit for bit, params, moments and
losses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch.train import _preset
from repro_torch.runtime import TrainConfig, Trainer
from repro_torch.runtime.ft import PreemptionGuard

LOSS_RTOL = 1e-5
#: a leaf's largest difference over its largest magnitude (the moments
#: carry the gradient; later steps are held by their losses, since AdamW's
#: early updates are about ``lr·sign(g)`` and a near-zero gradient's sign
#: may differ between two summation orders)
STATE_GAP = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cfg(**kw) -> TrainConfig:
    base = dict(global_batch=8, num_blocks=2, seq_len=32, steps=12, peak_lr=1e-3,
                warmup_steps=2)
    base.update(kw)
    return TrainConfig(**base)


def _model(dtype="float32"):
    return dataclasses.replace(_preset("lm1m"), dtype=dtype, attn_impl="flash")


@pytest.mark.parametrize("mode", ["spliter", "per_block", "materialized"])
def test_train_step_on_the_card_matches_the_cpu(dev, mode):
    cpu = Trainer(_model(), _cfg(accum_mode=mode), device="cpu")
    card = Trainer(_model(), _cfg(accum_mode=mode), device=dev)
    params, opt = cpu.init_state()
    gparams, gopt = tree_map(lambda t: t.to(dev), (params, opt))
    launches = (fa.flash_attention.launches, ss.ssd_scan.launches)
    for step in range(3):  # step 1 moves no weight (lr 0); 2 and 3 do
        blocks = cpu.pipeline.peek(step)
        params, opt, loss, n = cpu.train_step(params, opt, blocks)
        gparams, gopt, gloss, gn = card.train_step(gparams, gopt, blocks)
        assert gn == n and gloss.device.type == "cuda"
        np.testing.assert_allclose(float(gloss), float(loss), rtol=LOSS_RTOL)
        if step == 0:  # the state after one update on equal inputs, tightly
            for a, b in zip(tree_leaves((gparams, gopt)), tree_leaves((params, opt))):
                assert a.device.type == "cuda" and a.dtype == b.dtype
                gap = float((a.cpu().double() - b.double()).abs().max())
                assert gap <= STATE_GAP * float(b.double().abs().max()), gap
    assert (fa.flash_attention.launches, ss.ssd_scan.launches) == launches


def test_resume_on_the_card_is_bit_identical(dev, tmp_path):
    mc = _model("bfloat16")
    full = Trainer(mc, _cfg(), device=dev).run(resume=False)
    guard = PreemptionGuard(install=False)

    def stop_at_6(step, loss):
        if step == 5:
            guard.request_stop()

    ck = str(tmp_path / "ck")
    first = Trainer(mc, _cfg(ckpt_dir=ck), device=dev).run(guard=guard, on_step=stop_at_6)
    assert first["preempted"] and first["stopped_at"] == 6
    resumed = Trainer(mc, _cfg(ckpt_dir=ck), device=dev).run(resume=True)
    assert resumed["stopped_at"] == 12
    for a, b in zip(tree_leaves((full["params"], full["opt"])),
                    tree_leaves((resumed["params"], resumed["opt"]))):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert full["losses"][6:] == resumed["losses"]
