"""How far apart f32 and bf16 train steps of jamba's smoke period stand
when nothing is wrong: the figures behind ``tests/test_torch_tp_train.py``'s
``V_RTOL`` and ``BF16_HELD_BY_F32``.  Not collected by pytest.

    PYTHONPATH=src:tests python tests/_torch_train_spread.py   # ~3 min on a CPU

It runs the reference child (``_torch_dist_ref.py``: the ``jamba/222`` and
``jamba_f32/222`` cases, and the reference's unsharded bf16 step under
``jax.jit``), then prints, each as the largest gap over a leaf's maximum
(and over the whole tree's norm where said):

* the reference's own sharded bf16 gradients against its unsharded ones;
* the port's unsharded and tensor-parallel bf16 gradients against the
  reference's f32 ones (leaf and tree norm);
* the port's unsharded f32 gradients against the same step's with every
  param moved by 1e-7 of itself (seeded), the f32 problem's conditioning.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def reference_side(out_dir: str) -> None:
    """In the child: the two cases and the unsharded bf16 gradients."""
    import jax
    import jax.numpy as jnp

    import _torch_dist_ref as ref
    from repro.configs import get_smoke_config
    from repro.models import build_model
    from repro.optim import accumulate_gradients

    ref.OUT = out_dir
    out: dict = {}
    for case in ("jamba/222", "jamba_f32/222"):
        ref.sharded_train(out, case, full=True)
    arch, ov, _, _ = ref.TRAIN_CASES["jamba/222"]
    model = build_model(dataclasses.replace(get_smoke_config(arch), **ov))
    blocks = {k: jnp.asarray(v) for k, v in ref.train_blocks(model.cfg.vocab_size).items()}
    _, grads = jax.jit(lambda p, b: accumulate_gradients(model.loss, p, b, mode="spliter"))(
        model.init(jax.random.key(0)), blocks)
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"unsharded_bf16/{ref.tp_path(path)}"] = np.asarray(leaf)
    np.savez(os.path.join(out_dir, "out.npz"), **{k: np.asarray(v) for k, v in out.items()})


def port_side(out_dir: str) -> None:
    import torch

    import test_torch_tp_train as t
    from repro_torch._pytree import tree_leaves, tree_map
    from repro_torch.distributed import device_put, params_shardings, spmd, train_rules
    from repro_torch.optim import accumulate_gradients

    with np.load(os.path.join(out_dir, "out.npz")) as data:
        reference = {**data, "dir": out_dir}
    names = None

    def gaps(got, want):
        leaf = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
        tree = (sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
                / sum(float((w ** 2).sum()) for w in want)) ** 0.5
        return leaf, tree

    model, params, mesh, blocks = t._problem(reference, "jamba/222")
    names = t._paths(params)
    f32 = [reference[f"tp_train/jamba_f32/222/grads/{n}"] for n in names]
    sharded = [reference[f"tp_train/jamba/222/grads/{n}"] for n in names]
    unsharded = [reference[f"unsharded_bf16/{n}"] for n in names]
    print("reference bf16, sharded against unsharded (leaf):", gaps(sharded, unsharded)[0])
    _, g_un = accumulate_gradients(model.loss, params, blocks)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    _, g_tp = spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                             rules=train_rules(mesh))
    print("port bf16 unsharded against reference f32 (leaf, tree):",
          gaps([g.numpy() for g in tree_leaves(g_un)], f32))
    print("port bf16 tensor-parallel against reference f32 (leaf, tree):",
          gaps([g.full().numpy() for g in tree_leaves(g_tp)], f32))
    model, params, _, blocks = t._problem(reference, "jamba_f32/222")
    _, a = accumulate_gradients(model.loss, params, blocks)
    gen = torch.Generator().manual_seed(1)
    moved = tree_map(lambda p: p * (1 + 1e-7 * torch.randn(p.shape, generator=gen)), params)
    _, b = accumulate_gradients(model.loss, moved, blocks)
    print("port f32, params moved by 1e-7 (leaf):",
          gaps([x.numpy() for x in tree_leaves(b)], [x.numpy() for x in tree_leaves(a)])[0])


if __name__ == "__main__":
    if len(sys.argv) > 1:  # the child
        sys.path.insert(0, HERE)
        reference_side(sys.argv[1])
        sys.exit(0)
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, __file__, tmp], env=env, check=True,
                       stderr=subprocess.DEVNULL)
        port_side(tmp)
