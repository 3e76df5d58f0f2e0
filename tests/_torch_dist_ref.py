"""Reference side of ``tests/test_torch_distributed.py`` and
``tests/test_torch_tensor_parallel.py``, run in a child process on 8 forced
host devices.

The parent sets ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` so
that its own process keeps one device.  This child takes the output
directory and then the names of the cases to run: by default every case of
:data:`CASES` (every mode of ``tests/_dist_child.py`` that the port mirrors,
not ``mesh_exec``, and the ``jax.lax`` collectives on the same mesh
shapes, and ``moe_groups``: mixtral's train step at a capacity that drops);
``tensor_parallel`` (the reference's serving steps under GSPMD) is the
tensor-parallel test's, ``long_decode`` (the same under
``long_decode_rules``, a batch of one) the long-context test's,
``tp_train`` (the train step under ``train_rules`` on two meshes, its
gradients, params and moments) and ``collective_grads`` (``jax.grad``
through each collective) the tensor-parallel training test's
(``tests/test_torch_tp_train.py``).  It saves what each produced to
``out.npz`` in the directory (and the train steps' params, as
checkpoints, under ``params/``, ``params_mixtral/``, ``params_mamba2/`` and
``params_jamba/`` there).  The inputs are drawn
here exactly as the parent draws them for the port (numpy generators,
fixed seeds).  Not collected by pytest (no ``test_`` prefix).
"""

import dataclasses
import os
import sys
import tempfile

import numpy as np


def _mesh(shape, axes):
    from repro.launch.mesh import compat_make_mesh

    return compat_make_mesh(shape, axes)


def hier_and_compressed(out: dict) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.distributed.collectives import compressed_psum_pod, hierarchical_psum
    from repro.distributed.compat import shard_map

    mesh = _mesh((2, 4), ("pod", "data"))
    sm = lambda f: shard_map(f, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)  # noqa: E731
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    out["hier_psum/hier"] = sm(lambda v: hierarchical_psum(v, fast_axis="data", slow_axis="pod"))(x)
    out["hier_psum/flat"] = sm(lambda v: jax.lax.psum(v, ("data", "pod")))(x)
    x = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
    out["compressed_psum"] = sm(
        lambda v: compressed_psum_pod(v, fast_axis="data", slow_axis="pod"))(x)


def gpipe_case(out: dict) -> None:
    import jax.numpy as jnp

    from repro.distributed.pipeline_par import gpipe

    mesh = _mesh((4, 2), ("pipe", "data"))
    s, t, mb, d = 4, 6, 8, 16
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((s, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.standard_normal((s, d)) * 0.1).astype(np.float32)
    xs = rng.standard_normal((t, mb, d)).astype(np.float32)
    out["gpipe"] = gpipe(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                         {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(xs),
                         mesh=mesh, axis="pipe")


#: the tensor-parallel train cases: name -> (arch, config overrides, mesh
#: shape and axes, checkpoint folder): qwen3's smoke config as it is and in
#: f32, on (2, 2, 2) ("pod", "data", "model") and on (2, 4) ("data",
#: "model"), where its 2 kv heads do not divide the model axis; mamba2's
#: and jamba's in f32 on both (8 SSM heads: 4 and 2 a rank), jamba's as it
#: is (bf16 compute) on (2, 2, 2); mixtral's in f32 on (2, 4) (4 experts,
#: one a rank) and at capacity factor 1 (below E/k = 2, so that the groups
#: drop choices) on (2, 2, 2), whose 8-row blocks (one 128-token group)
#: split over 4 data-parallel ranks leave each rank 32 tokens, not whole
#: groups
TRAIN_MESHES = {"222": ((2, 2, 2), ("pod", "data", "model")), "24": ((2, 4), ("data", "model"))}
TRAIN_CASES = {
    "qwen3/222": ("qwen3-32b", {}, "222", "params"),
    "qwen3/24": ("qwen3-32b", {}, "24", "params"),
    "qwen3_f32/222": ("qwen3-32b", {"dtype": "float32"}, "222", "params"),
    "qwen3_f32/24": ("qwen3-32b", {"dtype": "float32"}, "24", "params"),
    "mixtral_cf1/222": ("mixtral-8x7b", {"dtype": "float32", "moe_capacity_factor": 1.0},
                           "222", "params_mixtral"),
    "mixtral_f32/24": ("mixtral-8x7b", {"dtype": "float32"}, "24", "params_mixtral"),
    "mamba2_f32/222": ("mamba2-1.3b", {"dtype": "float32"}, "222", "params_mamba2"),
    "mamba2_f32/24": ("mamba2-1.3b", {"dtype": "float32"}, "24", "params_mamba2"),
    "jamba_f32/222": ("jamba-v0.1-52b", {"dtype": "float32"}, "222", "params_jamba"),
    "jamba_f32/24": ("jamba-v0.1-52b", {"dtype": "float32"}, "24", "params_jamba"),
    "jamba/222": ("jamba-v0.1-52b", {}, "222", "params_jamba"),
}
TRAIN_LR = 1e-3


def train_blocks(vocab: int) -> dict[str, np.ndarray]:
    """Two blocks of 8 × 16 tokens and labels, shared with the parent."""
    rng = np.random.default_rng(3)
    return {k: rng.integers(0, vocab, (2, 8, 16)).astype(np.int32) for k in ("tokens", "labels")}


def sharded_train(out: dict, case: str = "qwen3/222", full: bool = False) -> None:
    """``_dist_child.check_sharded_train_step``: ``jax.jit(step)`` under
    ``train_rules`` on the case's mesh, params by ``params_shardings`` (the
    ``fsdp`` dims over data), the blocks' rows over the data-parallel axes;
    saves the loss and the unsharded one (not for an f32 case with
    ``full``, which the parent holds to the step's own loss), and with
    ``full`` the step's gradients, new params and both moments, keyed by
    param path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.checkpoint import Checkpointer
    from repro.configs import get_smoke_config
    from repro.distributed.sharding import params_shardings, train_rules, use_rules
    from repro.models import build_model
    from repro.optim import accumulate_gradients, adamw_init, adamw_update

    arch, ov, mesh_name, folder = TRAIN_CASES[case]
    mesh = _mesh(*TRAIN_MESHES[mesh_name])
    model = build_model(dataclasses.replace(get_smoke_config(arch), **ov))
    params = model.init(jax.random.key(0))
    opt = adamw_init(params)
    blocks = {k: jnp.asarray(v) for k, v in train_blocks(model.cfg.vocab_size).items()}
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))

    def step(params, opt, blocks):
        loss, grads = accumulate_gradients(model.loss, params, blocks, mode="spliter")
        p2, o2 = adamw_update(params, grads, opt, lr=TRAIN_LR)
        return p2, o2, loss, grads

    ckpt = os.path.join(OUT, folder)
    if not os.path.isdir(ckpt):
        Checkpointer(ckpt).save(0, params)  # the port restores these
    p_sh = params_shardings(params, mesh)
    b_sh = {k: NamedSharding(mesh, P(None, dp, None)) for k in blocks}
    params = jax.device_put(params, p_sh)
    blocks = jax.device_put(blocks, b_sh)
    with use_rules(train_rules(mesh)):
        new_p, new_opt, loss, grads = jax.jit(step, in_shardings=(p_sh, None, b_sh))(
            params, opt, blocks)
    key = "sharded_train" if case == "qwen3/222" and not full else f"tp_train/{case}"
    out[f"{key}/loss"] = np.float32(loss)
    if not (full and ov.get("dtype") == "float32"):  # an f32 case is held to the step alone
        loss_ref, _ = accumulate_gradients(
            model.loss, jax.device_get(params), jax.device_get(blocks), mode="spliter")
        out[f"{key}/loss_ref"] = np.float32(loss_ref)
    if full:
        for name, tree in (("grads", grads), ("params", new_p), ("m", new_opt.m),
                           ("v", new_opt.v)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out[f"{key}/{name}/{tp_path(path)}"] = np.asarray(leaf)


def tp_train(out: dict) -> None:
    """Every case of :data:`TRAIN_CASES`, with its gradients, params and
    moments."""
    for case in TRAIN_CASES:
        sharded_train(out, case, full=True)


def moe_groups(out: dict) -> None:
    """Mixtral's case of :data:`TRAIN_CASES`: the MoE groups of the whole
    batch where a rank's rows are not whole groups."""
    sharded_train(out, "mixtral_cf1/222", full=True)


#: the collectives' gradients: name -> (the operand's kind, body over
#: (lax-like namespace, the rank's operand, its weights)): each body ends in
#: a loss every rank holds alike, and the gradient of the operand comes
#: back laid out as it went in
GRAD_PRIMITIVES = {
    "psum": ("split", lambda lx, v, w: lx.psum(
        (lx.psum(v * w, "model") ** 2).sum(), "data")),
    "all_gather/tiled": ("split", lambda lx, v, w: lx.psum(
        (lx.all_gather(v, "model", axis=0, tiled=True) ** 2 * lx.all_gather(
            w, "model", axis=0, tiled=True) * (1 + lx.axis_index("model"))).sum(),
        ("data", "model"))),
    "all_gather/untiled": ("split", lambda lx, v, w: lx.psum(
        (lx.all_gather(v * w, "model", axis=1, tiled=False) ** 2).sum()
        * (1 + lx.axis_index("model")), ("data", "model"))),
    "psum_scatter/tiled": ("tiles", lambda lx, v, w: lx.psum(
        (lx.psum_scatter(v * w, "model", scatter_dimension=0, tiled=True) ** 2).sum(),
        ("data", "model"))),
    "psum_scatter/untiled": ("tiles", lambda lx, v, w: lx.psum(
        (lx.psum_scatter((v * w).reshape(4, 1, 3), "model", scatter_dimension=0,
                         tiled=False) ** 3).sum(), ("data", "model"))),
    "pvary": ("rows", lambda lx, v, w: lx.psum(
        (lx.pvary(v, "model") ** 2 * w * (1 + lx.axis_index("model"))).sum(),
        ("data", "model"))),
}
#: kind -> (the operand's and its weights' shape, the axes their rows are
#: split over on the (2, 4) ("data", "model") mesh): a rank holds a (1, 3)
#: block of ``split``, a (4, 3) block of ``rows`` (the same on every model
#: rank) and a (4, 3) block of ``tiles``
GRAD_KINDS = {"split": ((8, 3), ("data", "model")), "rows": ((8, 3), ("data",)),
              "tiles": ((32, 3), ("data", "model"))}


def grad_inputs(kind: str) -> tuple[np.ndarray, np.ndarray]:
    """The operand and its weights of ``kind``, shared with the parent."""
    rng = np.random.default_rng(23)
    shape = GRAD_KINDS[kind][0]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def collective_grads(out: dict) -> None:
    """``jax.grad`` of each :data:`GRAD_PRIMITIVES` body's loss through
    ``shard_map`` (``check_vma`` on: the transposes of psum, all_gather,
    psum_scatter and pvary)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed.compat import shard_map

    class Lax:
        psum = staticmethod(jax.lax.psum)
        psum_scatter = staticmethod(jax.lax.psum_scatter)
        all_gather = staticmethod(jax.lax.all_gather)
        axis_index = staticmethod(jax.lax.axis_index)
        pvary = staticmethod(lambda x, axis: jax.lax.pcast(x, axis, to="varying"))

    mesh = _mesh((2, 4), ("data", "model"))
    for name, (kind, body) in GRAD_PRIMITIVES.items():
        spec = P(GRAD_KINDS[kind][1])
        f = shard_map(lambda v, w, body=body: body(Lax, v, w), mesh=mesh,
                      in_specs=(spec, spec), out_specs=P())
        v, w = grad_inputs(kind)
        out[f"collective_grad/{name}"] = jax.grad(f)(jnp.asarray(v), jnp.asarray(w))


def elastic_restore(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.checkpoint import Checkpointer

    mesh8 = _mesh((8,), ("data",))
    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    tree = {"w": jax.device_put(x, NamedSharding(mesh8, P("data"))),
            "b": jnp.ones((3,), jnp.float32)}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(7, tree, extras={"note": "elastic"}, blocking=True)
        mesh2 = _mesh((2,), ("data",))
        sh2 = {"w": NamedSharding(mesh2, P("data")), "b": NamedSharding(mesh2, P())}
        got, extras, step = ck.restore(
            {"w": jnp.zeros_like(x), "b": jnp.zeros((3,), jnp.float32)}, shardings=sh2)
    assert step == 7 and extras["note"] == "elastic"
    out["elastic_restore/w"] = got["w"]
    out["elastic_restore/b"] = got["b"]
    out["elastic_restore/num_devices"] = np.int32(got["w"].sharding.num_devices)


def cache_writes(out: dict) -> None:
    """``check_sharded_cache_write`` and ``check_heads_dus_cache_write``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.distributed.sharding import decode_rules, decode_rules_headsharded, use_rules
    from repro.models.layers import cache_write

    mesh = _mesh((2, 4), ("data", "model"))
    for mode, seed, h, rules, spec in (
        ("cache_write", 5, 2, dataclasses.replace(decode_rules(mesh), cache_impl="sharded_dus"),
         P(("data",), "model", None, None)),
        ("heads_cache", 7, 4, decode_rules_headsharded(mesh), P(("data",), None, "model", None)),
    ):
        rng = np.random.default_rng(seed)
        b, s, d = 4, 16, 8
        masked = jnp.zeros((b, s, h, d), jnp.float32)
        sharded = jax.device_put(masked, NamedSharding(mesh, spec))

        def write(c, n, p, rules=rules):
            with use_rules(rules):
                return cache_write(c, n, p)

        js = jax.jit(write, donate_argnums=(0,))
        for pos in range(s):
            new = jnp.asarray(rng.standard_normal((b, 1, h, d)), jnp.float32)
            masked = cache_write(masked, new, jnp.asarray(pos, jnp.int32))
            sharded = js(sharded, new, jnp.asarray(pos, jnp.int32))
        out[f"{mode}/masked"] = masked
        out[f"{mode}/rules"] = sharded


def primitive_inputs() -> dict[str, np.ndarray]:
    """The collectives' operands, shared with the parent."""
    rng = np.random.default_rng(11)
    return {
        "rows": rng.standard_normal((8, 6)).astype(np.float32),
        "blocks": rng.standard_normal((8 * 4, 3)).astype(np.float32),
        "tiles": rng.standard_normal((8 * 8, 3)).astype(np.float32),
        "ones": rng.standard_normal((8, 3)).astype(np.float32),
    }


#: name -> (input key, body over (lax-like namespace, local value)): each runs
#: on a (2, 4) ("pod", "data") mesh with in_specs and out_specs
#: P(("pod", "data")), so every rank's result comes back in rank order
PRIMITIVES = {
    "psum/data": ("rows", lambda lx, v: lx.psum(v, "data")),
    "psum/pod": ("rows", lambda lx, v: lx.psum(v, "pod")),
    "psum/pod_data": ("rows", lambda lx, v: lx.psum(v, ("data", "pod"))),
    "pmax/data": ("rows", lambda lx, v: lx.pmax(v, "data")),
    "pmax/pod_data": ("rows", lambda lx, v: lx.pmax(v, ("data", "pod"))),
    "psum_scatter/untiled": ("blocks", lambda lx, v: lx.psum_scatter(
        v, "data", scatter_dimension=0, tiled=False)[None]),
    "psum_scatter/tiled": ("tiles", lambda lx, v: lx.psum_scatter(
        v, "data", scatter_dimension=0, tiled=True)),
    "psum_scatter/dim1": ("tiles", lambda lx, v: lx.psum_scatter(
        v.reshape(2, 4, 3), "data", scatter_dimension=1, tiled=False)),
    "all_gather/untiled": ("ones", lambda lx, v: lx.all_gather(v, "data", axis=1, tiled=False)),
    "all_gather/tiled": ("ones", lambda lx, v: lx.all_gather(v, "data", axis=1, tiled=True)),
    "all_gather/pod_data": ("ones", lambda lx, v: lx.all_gather(
        v, ("pod", "data"), axis=0, tiled=True)[None]),
    "ppermute/shift": ("rows", lambda lx, v: lx.ppermute(v, "data", [(0, 1), (1, 2), (2, 3)])),
    "ppermute/swap_pod": ("rows", lambda lx, v: lx.ppermute(v, "pod", [(0, 1), (1, 0)])),
    "axis_index": ("ones", lambda lx, v: v * 0 + lx.axis_index("data")
                   + 10 * lx.axis_index(("pod", "data"))),
    "axis_size": ("ones", lambda lx, v: v * 0 + lx.axis_size(("pod", "data"))
                  + 100 * lx.axis_size("data")),
}


def primitives(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed.compat import axis_size, shard_map

    class Lax:
        psum = staticmethod(jax.lax.psum)
        pmax = staticmethod(jax.lax.pmax)
        psum_scatter = staticmethod(jax.lax.psum_scatter)
        all_gather = staticmethod(jax.lax.all_gather)
        ppermute = staticmethod(jax.lax.ppermute)
        axis_index = staticmethod(jax.lax.axis_index)

    Lax.axis_size = staticmethod(axis_size)
    mesh = _mesh((2, 4), ("pod", "data"))
    spec = P(("pod", "data"))
    inputs = primitive_inputs()
    for name, (key, body) in PRIMITIVES.items():
        f = shard_map(lambda v, body=body: body(Lax, v), mesh=mesh, in_specs=(spec,),
                      out_specs=spec, check_vma=False)
        out[f"primitive/{name}"] = f(jnp.asarray(inputs[key]))


#: the tensor-parallel serving case: the smoke configs in f32 (qwen3's and
#: mixtral's 2 kv heads do not divide the 4-way model axis, deepseek's 4 do;
#: mamba2's and jamba's 8 SSM heads split 2 a rank, jamba's and mixtral's 4
#: experts 1 a rank; deepseek-v2's MLA heads 1 a rank, its kv_lora_rank 32
#: split 8 a rank under the heads layout, its 8 experts 2 a rank; whisper's
#: 4 heads 1 a rank, in the encoder, the decoder's self- and cross-attention;
#: the vlm's 4 q heads 1 a rank, its 2 kv heads replicated), a batch of
#: TP_BATCH TP_PROMPT-token prompts with whisper's frames or the vlm's image
#: embeddings (tp_extras, split over data), then TP_STEPS decode steps, the
#: vlm's fed the image embeddings again, as the reference's server feeds
#: them; the cache TP_MAX_LEN long; the reference's init at key 0 with the
#: cross-attention gates drawn by tp_gates (the init's 0 would hide the
#: cross path)
TP_ARCHES = ("qwen3-32b", "deepseek-7b", "mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x7b",
             "deepseek-v2-236b", "whisper-tiny", "llama-3.2-vision-11b")
TP_BATCH, TP_PROMPT, TP_STEPS, TP_MAX_LEN = 4, 8, 3, 16
TP_LAYOUTS = ("seq", "heads")
#: the reference cases beside TP_ARCHES: name -> (arch, config overrides,
#: prompt, steps).  ``chunked``: a prompt of 2 × ssm_chunk (16) tokens, the
#: SSD's chunked route; ``cf1.25``: the published capacity factor, where the
#: groups drop choices (the smoke configs' 2.0 = E/k drops none); ``roll``: a
#: window of 4 below the 8-token prompt, which the prefill rolls into the
#: 4-slot ring; ``wrap``: a 12-slot ring that the decode steps at positions
#: 12 and 13 wrap; ``kv4``: the vlm's memory projection split by its 4 kv
#: heads; ``h6``: whisper's 6 heads, which do not divide the 4-way axis, as
#: its 6 at full width divide neither 4 nor 16
TP_CASES = {
    "mamba2-1.3b/chunked": ("mamba2-1.3b", {}, 32, TP_STEPS),
    "mixtral-8x7b/cf1.25": ("mixtral-8x7b", {"moe_capacity_factor": 1.25}, TP_PROMPT, TP_STEPS),
    "jamba-v0.1-52b/cf1.25": ("jamba-v0.1-52b", {"moe_capacity_factor": 1.25}, TP_PROMPT,
                              TP_STEPS),
    "mixtral-8x7b/roll": ("mixtral-8x7b", {"sliding_window": 4}, TP_PROMPT, TP_STEPS),
    "mixtral-8x7b/wrap": ("mixtral-8x7b", {"sliding_window": 12}, TP_PROMPT, 6),
    "deepseek-v2-236b/cf1.25": ("deepseek-v2-236b", {"moe_capacity_factor": 1.25}, TP_PROMPT,
                                TP_STEPS),
    "llama-3.2-vision-11b/kv4": ("llama-3.2-vision-11b", {"num_kv_heads": 4}, TP_PROMPT,
                                 TP_STEPS),
    "whisper-tiny/h6": ("whisper-tiny", {"num_heads": 6, "num_kv_heads": 6}, TP_PROMPT,
                        TP_STEPS),
}


def tp_case(name: str) -> tuple[str, dict, int, int, int]:
    """(arch, overrides, prompt, steps, max_len) of a TP_ARCHES arch or a
    TP_CASES case; the cache holds the prompt and the steps."""
    arch, ov, prompt, steps = TP_CASES.get(name, (name, {}, TP_PROMPT, TP_STEPS))
    return arch, ov, prompt, steps, max(TP_MAX_LEN, prompt + steps)


def tp_tokens(vocab: int, length: int = TP_PROMPT + TP_STEPS, batch: int = TP_BATCH
              ) -> np.ndarray:
    """The prompts and the decode steps' tokens (batch, length)."""
    return np.random.default_rng(13).integers(0, vocab, (batch, length)).astype(np.int32)


def tp_extras(cfg, batch: int = TP_BATCH) -> dict[str, np.ndarray]:
    """The stubbed frontends' outputs for the prompts, numpy f32: whisper's
    ``frames``, the vlm's ``image_embeds`` (the decode steps' memory too);
    empty for the other families."""
    rng = np.random.default_rng(17)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "vlm":
        return {"image_embeds": rng.normal(size=(batch, cfg.image_tokens,
                                                 cfg.image_embed_dim)).astype(np.float32)}
    return {}


def tp_gates(tree):
    """A numpy params tree with every cross-attention ``gate`` at a seeded
    value in [0.5, 1.5]."""
    rng = np.random.default_rng(19)

    def walk(node):
        if isinstance(node, dict):
            return {k: rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "gate"
                    else walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def tp_path(path) -> str:
    """A cache leaf's path as ``seg0/0/k``: dict keys and sequence indices."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def tensor_parallel(out: dict) -> None:
    """``jax.jit(model.prefill)`` and ``jax.jit(model.decode_step)`` on a
    (2, 4) ("data", "model") mesh, params by ``params_shardings`` (no
    ``fsdp``, as ``_serving_fsdp`` keeps the smoke configs), the cache by
    ``cache_shardings`` under ``decode_rules`` (``layout="seq"``) and
    ``decode_rules_headsharded`` (``"heads"``), the logits out as
    ``P("data", "model")`` (``repro/launch/dryrun_lib.py:145-212``): the
    logits after the prefill and each decode step, and every rank's block
    of the final cache (rank order)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.distributed.sharding import (
        cache_shardings,
        decode_rules,
        decode_rules_headsharded,
        params_shardings,
    )
    from repro.models import build_model

    mesh = _mesh((2, 4), ("data", "model"))
    for name in (*TP_ARCHES, *TP_CASES):
        arch, ov, prompt, steps, max_len = tp_case(name)
        model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32", **ov))
        params = jax.tree.map(jnp.asarray,
                              tp_gates(jax.tree.map(np.asarray, model.init(jax.random.key(0)))))
        toks = jnp.asarray(tp_tokens(model.cfg.vocab_size, prompt + steps))
        extras = {k: jnp.asarray(v) for k, v in tp_extras(model.cfg).items()}
        p_sh = params_shardings(params, mesh, fsdp_axis=None)
        rows = NamedSharding(mesh, P("data", None))
        e_sh = {k: NamedSharding(mesh, P("data", None, None)) for k in extras}
        logits_sh = NamedSharding(mesh, P("data", "model"))
        if model.cfg.moe_capacity_factor < model.cfg.moe_experts / max(model.cfg.moe_top_k, 1):
            out[f"tensor_parallel/{name}/drops"] = moe_drops(model, params, toks, prompt, steps,
                                                             max_len)
        for layout, rules in zip(TP_LAYOUTS, (decode_rules(mesh), decode_rules_headsharded(mesh))):
            cache = model.init_cache(TP_BATCH, max_len, jnp.float32)
            c_sh = cache_shardings(cache, mesh, layout=layout)
            serve_jitted(out, f"tensor_parallel/{name}/{layout}", model, params, p_sh, toks,
                         extras, cache, c_sh, rules, mesh, prompt, steps,
                         (rows, e_sh, logits_sh))


def serve_jitted(out: dict, key: str, model, params, p_sh, toks, extras: dict, cache, c_sh,
                 rules, mesh, prompt: int, steps: int, shardings: tuple) -> None:
    """``jax.jit(model.prefill)`` of ``toks[:, :prompt]`` (and ``extras``)
    into ``cache`` placed by ``c_sh``, then ``steps`` ``jax.jit(model.decode_step)``
    fed the next tokens (and the vlm's image embeddings), under ``rules``,
    the tokens, the extras and the logits laid out by ``shardings``
    ``(tokens, {extra: sharding}, logits)``: saves under ``key`` the logits
    after the prefill and each step, and every rank's block of the final
    cache (rank order)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.distributed.sharding import use_rules

    rows, e_sh, logits_sh = shardings
    memory = extras.get("image_embeds")  # every decode step's, as the server passes it
    with use_rules(rules):  # read while the steps trace
        prefill = jax.jit(model.prefill,
                          in_shardings=(p_sh, {"tokens": rows, **e_sh}, c_sh),
                          out_shardings=(logits_sh, c_sh))
        scalar = NamedSharding(mesh, P())
        decode = jax.jit(model.decode_step,
                         in_shardings=(p_sh, c_sh, rows, scalar) + (
                             () if memory is None else (e_sh["image_embeds"],)),
                         out_shardings=(logits_sh, c_sh))
        placed = jax.device_put(params, p_sh)
        logits, cache = prefill(placed, {"tokens": toks[:, :prompt], **extras},
                                jax.device_put(cache, c_sh))
        outs = [logits]
        for t in range(steps):
            logits, cache = decode(placed, cache, toks[:, prompt + t:prompt + t + 1],
                                   jnp.asarray(prompt + t, jnp.int32),
                                   *(() if memory is None else (memory,)))
            outs.append(logits)
    out[f"{key}/logits"] = np.stack([np.asarray(o) for o in outs], 1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        blocks = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        out[f"{key}/cache/{tp_path(path)}"] = np.stack([blocks[d] for d in mesh.devices.flat])


#: the long-context serving case (``long_decode_rules``): a batch of
#: LD_BATCH, its cache's sequence over data (``cache_shardings(
#: long_context=True)``: every kv head and the whole latent on each rank),
#: every TP_ARCHES arch and the LD_CASES of TP_CASES; the cache's length
#: rounded up to a multiple of the data axis (2), so that the sequence
#: really splits
LD_BATCH = 1
LD_CASES = ("mamba2-1.3b/chunked", "mixtral-8x7b/cf1.25", "jamba-v0.1-52b/cf1.25",
            "deepseek-v2-236b/cf1.25", "mixtral-8x7b/roll", "mixtral-8x7b/wrap")


def ld_case(name: str) -> tuple[str, dict, int, int, int]:
    """(arch, overrides, prompt, steps, max_len) of a long-context case."""
    arch, ov, prompt, steps, max_len = tp_case(name)
    return arch, ov, prompt, steps, -(-max_len // 2) * 2


def long_decode(out: dict) -> None:
    """``jax.jit(model.prefill)`` and ``jax.jit(model.decode_step)`` of a
    batch of one on a (2, 4) ("data", "model") mesh under
    ``long_decode_rules``: params by ``params_shardings`` (no ``fsdp``), the
    cache by ``cache_shardings(long_context=True)``, the tokens and extras
    replicated (``P(None, ...)``) and the logits out as ``P(None,
    "model")`` (``repro/launch/dryrun_lib.py:180-212``); and, for a
    capacity case, the choices dropped (:func:`moe_drops`)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.distributed.sharding import cache_shardings, long_decode_rules, params_shardings
    from repro.models import build_model

    mesh = _mesh((2, 4), ("data", "model"))
    rules = long_decode_rules(mesh)
    for name in (*TP_ARCHES, *LD_CASES):
        arch, ov, prompt, steps, max_len = ld_case(name)
        model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32", **ov))
        params = jax.tree.map(jnp.asarray,
                              tp_gates(jax.tree.map(np.asarray, model.init(jax.random.key(0)))))
        toks = jnp.asarray(tp_tokens(model.cfg.vocab_size, prompt + steps, LD_BATCH))
        extras = {k: jnp.asarray(v) for k, v in tp_extras(model.cfg, LD_BATCH).items()}
        if model.cfg.moe_capacity_factor < model.cfg.moe_experts / max(model.cfg.moe_top_k, 1):
            out[f"long_decode/{name}/drops"] = moe_drops(model, params, toks, prompt, steps,
                                                         max_len, LD_BATCH)
        cache = model.init_cache(LD_BATCH, max_len, jnp.float32)
        shardings = (NamedSharding(mesh, P(None, None)),
                     {k: NamedSharding(mesh, P(None, None, None)) for k in extras},
                     NamedSharding(mesh, P(None, "model")))
        serve_jitted(out, f"long_decode/{name}", model, params,
                     params_shardings(params, mesh, fsdp_axis=None), toks, extras, cache,
                     cache_shardings(cache, mesh, long_context=True), rules, mesh, prompt, steps,
                     shardings)


def moe_drops(model, params, toks, prompt: int, steps: int, max_len: int,
              batch: int = TP_BATCH) -> np.ndarray:
    """The choices the MoE layers drop at capacity in the prefill and in
    each decode step ``(1 + steps,)``, from the same steps run op by op
    (``jax.disable_jit``, so that the scanned layers run as a loop) with
    the dispatch tensor read where ``_moe_onehot`` hands it to ``shard``:
    ``disp (n, g, E·vs, capacity)`` holds a 1 for each kept choice's slice."""
    import jax
    import jax.numpy as jnp

    import repro.models.moe as jmoe

    cfg = model.cfg
    seen: list = []

    def record(x, *names):
        if names == ("batch", None, "expert", None):  # disp, then comb
            seen.append(x)
        return x

    real, jmoe.shard = jmoe.shard, record
    drops = []
    try:
        with jax.disable_jit():
            cache = model.init_cache(batch, max_len, jnp.float32)
            for t in range(1 + steps):
                seen.clear()
                if t == 0:
                    _, cache = model.prefill(params, {"tokens": toks[:, :prompt]}, cache)
                    tokens = batch * prompt
                else:
                    pos = prompt + t - 1
                    _, cache = model.decode_step(params, cache, toks[:, pos:pos + 1],
                                                 jnp.asarray(pos, jnp.int32))
                    tokens = batch
                kept = sum(float(np.asarray(d).sum()) for d in seen[0::2])
                choices = len(seen) // 2 * tokens * cfg.moe_top_k
                drops.append(choices - kept / cfg.moe_virtual_split)
    finally:
        jmoe.shard = real
    return np.asarray(drops, np.float32)


#: the child's cases by name; the parent names the ones it needs after the
#: output directory (all of CASES by default)
CASES = {"hier_and_compressed": hier_and_compressed, "gpipe": gpipe_case,
         "sharded_train": sharded_train, "elastic_restore": elastic_restore,
         "cache_writes": cache_writes, "primitives": primitives, "moe_groups": moe_groups}
EXTRA_CASES = {"tensor_parallel": tensor_parallel, "long_decode": long_decode,
               "tp_train": tp_train, "collective_grads": collective_grads}


if __name__ == "__main__":
    import jax

    assert jax.device_count() == 8, jax.device_count()
    OUT = sys.argv[1]
    results: dict = {}
    for name in sys.argv[2:] or list(CASES):
        {**CASES, **EXTRA_CASES}[name](results)
    np.savez(os.path.join(OUT, "out.npz"), **{k: np.asarray(v) for k, v in results.items()})
    print(f"RESULT {OUT}")
