"""The port's Server against the JAX package's, on the same weights and prompts.

Both serve greedily from the same numpy weights (float32 smoke configs,
every cross-attention gate set to a seeded non-zero value) and, for the
audio and vlm families, the same frame or image embeddings as ``extras``.
Served tokens must be equal, except where the two logits involved are a
near-tie (the method of ``tests/test_runtime.py``: the reference's logits
of the two tokens differ by less than 1e-3), and the dispatch counts must
be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_models import extras, set_gates

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.runtime.server import Server as JServer
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import params_from_numpy
from repro_torch.runtime import Server

NEAR_TIE = 1e-3


@pytest.mark.parametrize("arch,attn_impl", [
    ("qwen3-32b", "ref"), ("qwen3-32b", "flash"), ("mamba2-1.3b", "ref"),
    ("qwen2-72b", "flash"), ("command-r-35b", "flash"), ("deepseek-7b", "flash"),
    ("mixtral-8x7b", "flash"), ("jamba-v0.1-52b", "flash"), ("deepseek-v2-236b", "ref"),
    ("whisper-tiny", "flash"), ("llama-3.2-vision-11b", "flash"),
])
def test_generate_matches_reference(arch, attn_impl):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl=attn_impl)
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tree = set_gates(jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.key(0))), 0)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
    ex = extras(cfg, 2)

    jsrv = JServer(jcfg, max_len=48)
    jsrv.load(jax.tree.map(jnp.asarray, tree))
    want, jstats = jsrv.generate(prompts, steps=8, greedy=True,
                                 extras={k: jnp.asarray(v) for k, v in ex.items()})
    srv = Server(cfg, max_len=48, device="cpu")
    srv.load(params_from_numpy(tree, cfg, device="cpu"))
    got, stats, logits = srv.generate(prompts, steps=8, greedy=True, extras=ex,
                                      return_logits=True)

    assert got.shape == want.shape == (2, 8) and got.dtype == np.int32
    assert stats.dispatches == jstats.dispatches == 9
    assert stats.tokens_out == jstats.tokens_out == 16
    assert tuple(logits.shape) == (2, 9, cfg.padded_vocab)
    # the port's own served logits pick its tokens
    np.testing.assert_array_equal(logits[:, :8].argmax(-1).numpy(), got)
    for b in range(got.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:  # after the first tie the two continuations differ
            t = diff[0]
            step = logits[b, t].numpy()
            assert abs(step[got[b, t]] - step[want[b, t]]) < NEAR_TIE, (b, t)


def test_server_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(get_smoke_config("qwen3-32b"))


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_cli.main(["--arch", "mamba2-1.3b", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--steps", "4"])
    out = capsys.readouterr().out
    assert "dispatches=5" in out and "first request's tokens:" in out


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_serve_cli_serves_frames_and_images(capsys, arch):
    """The audio family is served frame embeddings, the vlm image embeddings."""
    serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--steps", "4"])
    out = capsys.readouterr().out
    assert "dispatches=5" in out and "first request's tokens:" in out


def test_serve_cli_checkpoint_restore_not_ported(tmp_path):
    """``--ckpt-dir`` restores now (``tests/test_torch_runtime.py``); a
    directory without a committed checkpoint raises rather than serve
    random weights."""
    with pytest.raises(AssertionError, match="no committed checkpoint"):
        serve_cli.main(["--arch", "qwen3-32b", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)])
