"""The distribution substrate on the card: ranks as positions on ``cuda:0``.

Every test here needs an NVIDIA GPU; on a host without one each skips with
that reason.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_distributed.py

* Each collective on 8 card ranks equals the same collective on 8 CPU
  ranks bit for bit (an f32 sum folded in rank order is the same IEEE sum
  on both), and the hierarchical psum equals the flat one within 1e-6.
* The rank threads queue on the caller's current stream of the card.
* The sharded cache write lands in the caller's card tensor.
* gpipe over attention layers on the card launches the flash kernel once
  per layer, per rank, per tick, and equals the layers applied in order.
* The data-parallel gradients of lm1m on the card equal the unsharded ones'
  loss, and a checkpoint saved from 8 card ranks restores onto 2.
* Tensor-parallel serving on 4 card ranks launches the flash kernel once
  per rank and layer at the rank's heads, its placed shards are the
  ranks' own (no copy), and its logits equal the unsharded model's; the
  SSM, hybrid and MoE smoke configs launch the SSD kernel once per rank
  and mamba2 layer and equal the unsharded model in f32; MLA, the encoder
  and cross-attention equal it in f32, flash launched once per rank and
  attention layer with a prompt; a batch of one under ``long_decode_rules``
  on (2, 4) card ranks (the cache's rows over ``data``) launches both
  kernels once per rank and layer and equals the unsharded model in f32.
* Tensor-parallel training: a collective's autograd node, whose CUDA
  backward the card's autograd thread runs, raises there rather than
  hang; lm1m's train step on (2, 2, 2) and (1, 4) card ranks, its
  backward in segments, equals the unsharded step in f32; so do the SSM,
  hybrid and MoE smoke configs' gradients, their routes equal; mixtral's
  data-parallel step, whose MoE ranks gather the token rows over the data
  axes, runs its backward in segments on the card and equals the unsharded
  step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed import (
    NamedSharding,
    P,
    all_gather,
    data_parallel_gradients,
    cache_shardings,
    decode_rules,
    decode_rules_headsharded,
    device_put,
    gpipe,
    hierarchical_psum,
    long_decode_rules,
    params_shardings,
    ppermute,
    psum,
    psum_scatter,
    pvary,
    shard_map,
    sharded_decode_step,
    sharded_prefill,
    sharded_train_step,
    tensor_parallel_gradients,
    train_rules,
    use_rules,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.launch.train import _preset
from repro_torch.models.layers import cache_write
from repro_torch.models.lm import _apply_layer, build_model
from repro_torch.optim import accumulate_gradients, adamw_init, adamw_update

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _body(v):
    a = psum(v, "data")
    b = psum_scatter(v, "pod", scatter_dimension=1, tiled=True)
    c = all_gather(b, "pod", axis=1, tiled=True)
    d = ppermute(v, "data", [(0, 1), (1, 2), (2, 3)])
    return a, c, d


def test_collectives_on_card_ranks_equal_cpu_ranks(dev):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4096)).astype(np.float32))
    spec = P(("pod", "data"))
    outs = {}
    for d in (CPU, dev):
        f = shard_map(_body, mesh=compat_make_mesh((2, 4), ("pod", "data"), devices=(d,)),
                      in_specs=(spec,), out_specs=(spec, spec, spec))
        outs[d.type] = f(x.to(d))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.device == dev
        assert torch.equal(got.cpu(), want)


def test_hierarchical_psum_on_the_card(dev):
    mesh = compat_make_mesh((2, 4), ("pod", "data"), devices=(dev,))
    x = torch.randn((1024, 256), device=dev)
    sm = lambda f: shard_map(f, mesh=mesh, in_specs=(P(),), out_specs=P(),  # noqa: E731
                             check_vma=False)
    hier = sm(lambda v: hierarchical_psum(v, fast_axis="data", slow_axis="pod"))(x)
    flat = sm(lambda v: psum(v, ("data", "pod")))(x)
    assert torch.allclose(hier, flat, rtol=1e-6, atol=0)
    assert torch.allclose(hier, 8 * x, rtol=1e-5, atol=0)
    assert torch.equal(hier, sm(lambda v: hierarchical_psum(v, fast_axis="data",
                                                            slow_axis="pod"))(x))


def test_rank_threads_use_the_callers_stream(dev):
    mesh = compat_make_mesh((2, 4), ("pod", "data"), devices=(dev,))
    side = torch.cuda.Stream(dev)
    seen = []

    def body(v):
        seen.append(torch.cuda.current_stream(dev))
        return psum(v * 2, ("pod", "data"))

    with torch.cuda.stream(side):
        x = torch.ones((4, 1024), device=dev)
        out = shard_map(body, mesh=mesh, in_specs=(P(),), out_specs=P())(x)
    side.synchronize()
    assert len(seen) == 8 and all(s == side for s in seen)
    assert torch.equal(out, torch.full_like(out, 16.0))


def test_sharded_cache_write_lands_in_the_card_tensor(dev):
    mesh = compat_make_mesh((2, 4), ("data", "model"), devices=(dev,))
    rules = dataclasses.replace(decode_rules(mesh), cache_impl="sharded_dus")
    plain = torch.zeros((4, 16, 2, 8), device=dev)
    sharded = torch.zeros_like(plain)
    for pos in range(16):
        new = torch.randn((4, 1, 2, 8), device=dev)
        cache_write(plain, new, pos)
        with use_rules(rules):
            cache_write(sharded, new, pos)
    assert torch.equal(plain, sharded) and bool((sharded != 0).any())


def test_gpipe_launches_flash_per_rank_tick_and_layer(dev):
    cfg = dataclasses.replace(_preset("lm1m"), num_layers=4, attn_impl="flash",
                              dtype="bfloat16")
    weights = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), device=dev)
    ((spec,),) = (seg.period for seg in cfg.segments())
    stages = tree_map(lambda t: t.reshape(2, 2, *t.shape[1:]), weights["seg0"])
    ctx = {"positions": torch.arange(128, device=dev).expand(2, 128)}

    def stage_fn(p, x):
        for i in range(2):
            x = _apply_layer(tree_map(lambda t: t[i], p)[0], spec, cfg, x, ctx, None)
        return x

    xs = torch.randn((3, 2, 128, cfg.d_model), device=dev, dtype=torch.bfloat16)
    mesh = compat_make_mesh((2, 2), ("pipe", "data"), devices=(dev,))
    fa.flash_attention.launches = 0
    with torch.no_grad():
        got = gpipe(stage_fn, stages, xs, mesh=mesh)
        launches = fa.flash_attention.launches
        want = torch.stack([stage_fn(tree_map(lambda t: t[1], stages),
                                     stage_fn(tree_map(lambda t: t[0], stages), x)) for x in xs])
    assert launches == mesh.size * (3 + 2 - 1) * 2
    assert torch.equal(got, want)


def test_data_parallel_gradients_on_the_card(dev):
    cfg = _preset("lm1m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev, master=True)
    blocks = {k: torch.randint(0, cfg.vocab_size, (2, 8, 32), device=dev)
              for k in ("tokens", "labels")}
    mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"), devices=(dev,))
    loss, grads = data_parallel_gradients(model.loss, device_put(
        params, params_shardings(params, mesh)), blocks, mesh=mesh)
    loss_ref, grads_ref = accumulate_gradients(model.loss, params, blocks)
    assert abs(float(loss) - float(loss_ref)) <= 5e-3
    for g, r in zip(tree_leaves(grads), tree_leaves(grads_ref)):
        assert g.device == dev
        assert float((g - r).abs().max()) <= 2e-2 * (float(r.abs().max()) or 1.0)


def test_a_collective_node_backward_raises_on_the_card(dev):
    """``torch.autograd.grad`` through a ``pvary`` node on card ranks: the
    card's autograd thread runs the node's backward, which finds no rank
    there and raises on both ranks, with no hang."""
    errors = []

    def body(v):
        x = v.detach().requires_grad_()
        try:
            torch.autograd.grad(psum(pvary(x, "model").sum(), "model"), x)
        except RuntimeError as err:
            errors.append(str(err))
        return v

    mesh = compat_make_mesh((1, 2), ("data", "model"), devices=(dev,))
    shard_map(body, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"))(
        torch.ones((1, 4), device=dev))
    assert len(errors) == 2 and all("not its rank's" in e for e in errors)


@pytest.mark.parametrize("shape,axes", [((2, 2, 2), ("pod", "data", "model")),
                                        ((1, 4), ("data", "model"))])
def test_tensor_parallel_train_step_on_card_ranks(dev, shape, axes):
    """lm1m in f32 (TF32 off): ``tensor_parallel_gradients`` within 1e-5
    (loss, relative) and 1e-4 (each gradient leaf's maximum) of the
    unsharded step's, and one ``sharded_train_step(..., rules=...)``'s
    first moment within 1e-4 and params within 2·lr of the unsharded
    AdamW step's, every rank's shard on the card."""
    model = build_model(dataclasses.replace(_preset("lm1m"), dtype="float32"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev, master=True)
    g = torch.Generator(device=dev).manual_seed(1)
    blocks = {k: torch.randint(0, model.cfg.vocab_size, (2, 8, 64), generator=g, device=dev)
              for k in ("tokens", "labels")}
    mesh = compat_make_mesh(shape, axes, devices=(dev,))
    rules = train_rules(mesh)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    loss_ref, grads_ref = accumulate_gradients(model.loss, params, blocks)
    loss, grads = tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh, rules=rules)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for got, want in zip(tree_leaves(grads), tree_leaves(grads_ref)):
        assert all(t.device == dev for t in got.shards)
        assert float((got.full() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    new, opt, _ = sharded_train_step(model.loss, placed, adamw_init(params), blocks, mesh=mesh,
                                     lr=1e-3, rules=rules)
    ref_p, ref_opt = adamw_update(tree_map(torch.clone, params), grads_ref, adamw_init(params),
                                  lr=1e-3)
    for got, want in zip(tree_leaves(opt.m), tree_leaves(ref_opt.m)):
        assert float((got.full() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    for got, want in zip(tree_leaves(new), tree_leaves(ref_p)):
        assert float((got.full() - want).abs().max()) <= 2e-3


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x7b"])
def test_tensor_parallel_train_families_on_card_ranks(dev, arch):
    """The SSM, hybrid and MoE smoke configs in f32 (TF32 off): the
    tensor-parallel gradients on (2, 2, 2) card ranks within 1e-5 (loss,
    relative) and 1e-4 (each gradient leaf's maximum) of the unsharded
    step's, the routes (``moe_mlp.routes``) equal where the model has MoE
    layers, every rank's shard on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import moe_mlp

    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev, master=True)
    g = torch.Generator(device=dev).manual_seed(1)
    blocks = {k: torch.randint(0, model.cfg.vocab_size, (2, 8, 32), generator=g, device=dev)
              for k in ("tokens", "labels")}
    mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"), devices=(dev,))
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    moe_mlp.routes = []
    try:
        loss_ref, grads_ref = accumulate_gradients(model.loss, params, blocks)
        want_routes, moe_mlp.routes = moe_mlp.routes, []
        loss, grads = tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                                rules=train_rules(mesh))
        routes = moe_mlp.routes
    finally:
        moe_mlp.routes = None
    assert len(routes) == len(want_routes)
    assert all(torch.equal(a["experts"], b["experts"]) for a, b in zip(routes, want_routes))
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for got, want in zip(tree_leaves(grads), tree_leaves(grads_ref)):
        assert all(t.device == dev for t in got.shards)
        assert float((got.full() - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_data_parallel_moe_step_on_card_ranks(dev):
    """Mixtral's smoke config in f32 at capacity factor 1 on (2, 2, 2) card
    ranks: a rank's 32 tokens are not a whole 128-token group, so the MoE
    layer all-gathers the token rows over the data axes inside the
    forward.  On the card that gather's transpose cannot run on autograd's
    card thread; the data-parallel ranks run their backward in segments
    (``spmd.data_parallel_scope``), and the step's loss and gradients equal
    the unsharded step's within 1e-5 and 1e-4, its params within 2·lr."""
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), dtype="float32",
                              moe_capacity_factor=1.0)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev, master=True)
    g = torch.Generator(device=dev).manual_seed(1)
    blocks = {k: torch.randint(0, cfg.vocab_size, (2, 8, 16), generator=g, device=dev)
              for k in ("tokens", "labels")}
    mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"), devices=(dev,))
    placed = device_put(params, params_shardings(params, mesh))
    loss_ref, grads_ref = accumulate_gradients(model.loss, params, blocks)
    loss, grads = data_parallel_gradients(model.loss, placed, blocks, mesh=mesh)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for got, want in zip(tree_leaves(grads), tree_leaves(grads_ref)):
        assert got.device == dev
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    new, _, _ = sharded_train_step(model.loss, placed, adamw_init(params), blocks, mesh=mesh,
                                   lr=1e-3)
    ref_p, _ = adamw_update(tree_map(torch.clone, params), grads_ref, adamw_init(params),
                            lr=1e-3)
    for got, want in zip(tree_leaves(new), tree_leaves(ref_p)):
        assert float((got.full() - want).abs().max()) <= 2e-3


def test_checkpoint_from_8_card_ranks_restores_onto_2(dev, tmp_path):
    x = torch.randn((8, 64), device=dev)
    mesh8 = compat_make_mesh((8,), ("data",), devices=(dev,))
    mesh2 = compat_make_mesh((2,), ("data",), devices=(dev,))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"w": device_put(x, NamedSharding(mesh8, P("data")))})
    got, _, step = ck.restore({"w": torch.empty((8, 64), device="meta")},
                              shardings={"w": NamedSharding(mesh2, P("data"))})
    assert step == 3 and got["w"].sharding.num_devices == 2
    assert all(s.device == dev for s in got["w"].shards)
    assert torch.equal(got["w"].full(), x)


def _serve_on_ranks(model, params, toks, mesh, layout, dtype, extras=None):
    """The tensor-parallel prefill of 128 tokens and 4 decode steps on
    ``mesh``, and the unsharded model's on the same weights, with the
    prompts' ``extras`` (``frames`` or ``image_embeds``; the latter every
    decode step's memory too): both runs' logits (B, 5, Vp), the prefill's
    flash launches, and whether the cache was written into the placed
    shards themselves.  ``layout`` ``"long"``: ``long_decode_rules`` and
    ``cache_shardings(long_context=True)``."""
    extras = extras or {}
    memory = extras.get("image_embeds")
    rules = {"seq": decode_rules, "heads": decode_rules_headsharded,
             "long": long_decode_rules}[layout](mesh)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=None))
    c0 = model.init_cache(toks.shape[0], 136, dtype=dtype, device=toks.device)
    cache = device_put(c0, cache_shardings(c0, mesh, layout="seq" if layout == "long" else layout,
                                           long_context=layout == "long"))
    blocks = [s.data_ptr() for leaf in tree_leaves(cache) for s in leaf.shards]
    base = fa.flash_attention.launches
    with torch.no_grad():
        batch = {"tokens": toks[:, :128], **extras}
        got = [sharded_prefill(model, placed, batch, cache, mesh=mesh, rules=rules)[0]]
        launches = fa.flash_attention.launches - base
        want = [model.prefill(params, batch, c0)[0]]
        for t in range(128, 132):
            got.append(sharded_decode_step(model, placed, cache, toks[:, t:t + 1], t, memory,
                                           mesh=mesh, rules=rules)[0])
            want.append(model.decode_step(params, c0, toks[:, t:t + 1], t, memory)[0])
    in_place = [s.data_ptr() for leaf in tree_leaves(cache) for s in leaf.shards] == blocks
    return torch.stack(got, 1).float(), torch.stack(want, 1).float(), launches, in_place


@pytest.mark.parametrize("layout", ["seq", "heads"])
def test_tensor_parallel_serving_on_card_ranks(dev, layout):
    """qwen3's smoke config at 8 heads of 64 on 4 card ranks, in bf16 (the
    flash kernel's wgmma route) and f32 (its split route), on the same
    weights: the flash kernel launched 4 ranks × 2 layers in each prefill,
    the cache written into the placed shards themselves, and the logits
    after the prefill and 4 decode steps against the unsharded model's.
    In f32 the two differ only in the order of their sums (1e-4); in bf16
    each rank's partial products round before the ranks sum them, so the
    tensor-parallel logits may stand from the unsharded ones at most twice
    as far as the unsharded bf16 logits stand from the f32 ones."""
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config("qwen3-32b"), head_dim=64, num_heads=8,
                              num_kv_heads=4, attn_impl="flash")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 132)),
                           device=dev)
    mesh = compat_make_mesh((1, 4), ("data", "model"), devices=(dev,))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    got, want, launches, in_place = _serve_on_ranks(model, params, toks, mesh, layout,
                                                    torch.bfloat16)
    assert launches == 4 * cfg.num_layers and in_place
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    got32, want32, launches, in_place = _serve_on_ranks(f32, params32, toks, mesh, layout,
                                                        torch.float32)
    assert launches == 4 * cfg.num_layers and in_place
    v = cfg.vocab_size
    err32 = float((got32[..., :v] - want32[..., :v]).abs().max())
    yardstick = float((want[..., :v] - want32[..., :v]).abs().max())
    err = float((got[..., :v] - want[..., :v]).abs().max())
    print(f"tensor-parallel {layout}: bf16 {err} (yardstick {yardstick}), f32 {err32}")
    torch.testing.assert_close(got32[..., :v], want32[..., :v], rtol=1e-4, atol=1e-4)
    assert err <= 2 * yardstick, (err, yardstick)


@pytest.mark.parametrize("layout", ["seq", "heads"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x7b"])
def test_tensor_parallel_families_on_card_ranks(dev, arch, layout):
    """The smoke configs in f32 on 4 card ranks under ``decode_rules``
    (``"seq"``) and ``decode_rules_headsharded`` (``"heads"``): a
    128-token prompt (the SSD's chunked route) launches ``ssd_scan`` once
    per rank and mamba2 layer and flash once per rank and attention layer,
    and the logits after the prefill and 4 decode steps equal the
    unsharded model's on the same weights within 1e-4 (the order of the
    sums)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ss

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 132)),
                           device=dev)
    mesh = compat_make_mesh((1, 4), ("data", "model"), devices=(dev,))
    base = ss.ssd_scan.launches
    got, want, flash, in_place = _serve_on_ranks(model, params, toks, mesh, layout,
                                                 torch.float32)
    mamba = sum(seg.repeats for seg in cfg.segments() for s in seg.period
                if s.mixer == "mamba2")
    attn = sum(seg.repeats for seg in cfg.segments() for s in seg.period if s.mixer == "attn")
    # the unsharded prefill launches the SSD kernel once per mamba2 layer too
    assert ss.ssd_scan.launches - base == 4 * mamba + mamba
    assert flash == 4 * attn and in_place
    v = cfg.vocab_size
    torch.testing.assert_close(got[..., :v], want[..., :v], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["seq", "heads"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "whisper-tiny", "llama-3.2-vision-11b"])
def test_tensor_parallel_latent_and_cross_on_card_ranks(dev, arch, layout):
    """MLA, the encoder and cross-attention: the smoke configs in f32 on 4
    card ranks under both rule sets, every cross gate at 1, fed whisper's
    frames or the vlm's image embeddings (every decode step's memory too):
    the flash kernel launched once per rank and attention layer with a
    prompt (whisper's encoder, self- and cross-attention; the vlm's; MLA
    none), the cache written in place, and the logits after the prefill and
    4 decode steps equal to the unsharded model's within 1e-4."""
    from repro_torch.configs import get_smoke_config

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    for seg in (v for k, v in params.items() if k.startswith("seg")):
        for layer in seg:
            if "gate" in layer["mixer"]:
                layer["mixer"]["gate"].fill_(1.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen,
                                       device=dev)
    if cfg.family == "vlm":
        extras["image_embeds"] = torch.randn((4, cfg.image_tokens, cfg.image_embed_dim),
                                             generator=gen, device=dev)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 132)),
                           device=dev)
    mesh = compat_make_mesh((1, 4), ("data", "model"), devices=(dev,))
    got, want, flash, in_place = _serve_on_ranks(model, params, toks, mesh, layout,
                                                 torch.float32, extras)
    prompt_attention = sum(seg.repeats for seg in (*cfg.segments(), *cfg.encoder_segments())
                           for s in seg.period if s.mixer in ("attn", "enc_attn", "cross_attn"))
    assert flash == 4 * prompt_attention and in_place
    v = cfg.vocab_size
    torch.testing.assert_close(got[..., :v], want[..., :v], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x7b",
                                  "deepseek-v2-236b"])
def test_long_decode_on_card_ranks(dev, arch):
    """A batch of one under ``long_decode_rules`` on (2, 4) card ranks, the
    smoke configs in f32: a 128-token prompt launches ``ssd_scan`` and
    flash once per rank and layer at the rank's heads (the prompt whole on
    both data ranks), the cache's rows over ``data`` are written in place,
    and the logits after the prefill and 4 decode steps equal the
    unsharded model's within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ss

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 132)),
                           device=dev)
    mesh = compat_make_mesh((2, 4), ("data", "model"), devices=(dev,))
    base = ss.ssd_scan.launches
    got, want, flash, in_place = _serve_on_ranks(model, params, toks, mesh, "long",
                                                 torch.float32)
    layers = {m: sum(seg.repeats for seg in cfg.segments() for s in seg.period if s.mixer == m)
              for m in ("mamba2", "attn")}
    assert ss.ssd_scan.launches - base == 8 * layers["mamba2"] + layers["mamba2"]
    assert flash == 8 * layers["attn"] and in_place
    v = cfg.vocab_size
    torch.testing.assert_close(got[..., :v], want[..., :v], rtol=1e-4, atol=1e-4)
