"""The port's dry-run (``repro_torch.launch.dryrun_lib``, ``Model.input_specs``,
``launch/perf.py``) and the LM kernels' shape-only routes, against the JAX
package's.

The reference's compiled records come from one child process on 8 forced
host devices (``tests/_torch_dryrun_ref.py``, ~65 s): ``run_cell`` and
``probe_cell`` for qwen3-32b's and mamba2-1.3b's smoke configs in a train,
a prefill and a decode cell (no probe of mamba2's train) on a (2, 4)
("data", "model") mesh, and ``run_cell`` with the compiled module's matrix
products on a data-parallel (2, 1) mesh, and the serving cells of
deepseek-7b, jamba-v0.1-52b, mixtral-8x7b, deepseek-v2-236b, whisper-tiny
and llama-3.2-vision-11b on (2, 4).  The port traces the same cells
on meshes of ``meta`` positions in this process.
Everything else compares the two packages' pure functions in-process, or
holds the port to itself: the depth fit against the full-depth count, the
kernels' formulas against closed forms counted another way, and the
``meta`` routes against the CPU routes.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dryrun_ref as ref_child
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import dryrun_lib as ref_lib
from repro.models import build_model as ref_build_model
from repro_torch._pytree import tree_leaves
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun_lib as lib
from repro_torch.launch import perf
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import build_model

# the reference's perf module sets XLA_FLAGS to 512 host devices when it is
# imported; a JAX backend started later in this process (another test file
# of the same worker) would see them, so the variable is put back
_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import perf as ref_perf  # noqa: E402

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
CHILD = os.path.join(os.path.dirname(__file__), "_torch_dryrun_ref.py")
META = torch.device("meta")
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The child's records, keyed by (arch, shape, "run" | "probe")."""
    path = str(tmp_path_factory.mktemp("dryrun_ref") / "records.json")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, CHILD, path], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"RESULT {path}" in out.stdout
    with open(path) as f:
        records = iter(json.load(f))
    got = {(a, s, kind): next(records) for a in ref_child.ARCHES
           for s in ref_child.SHAPE_NAMES for kind in ("run", "probe")
           if kind == "run" or (a, s) not in ref_child.NO_PROBE}
    got.update({(a, s, "data"): next(records) for a in ref_child.ARCHES
                for s in ref_child.SHAPE_NAMES})
    got.update({(a, s, "run"): next(records) for a, s in ref_child.TP_CELLS})
    assert next(records, None) is None
    return got


@pytest.fixture
def small_shapes(monkeypatch):
    """The child's small shape cells under the real names, in the port."""
    for name, (kind, seq, batch) in ref_child.SMALL_SHAPES.items():
        monkeypatch.setitem(SHAPES, name, ShapeCell(name, kind, seq, batch))


def _meta_mesh(shape=ref_child.MESH[0], axes=ref_child.MESH[1]):
    return compat_make_mesh(shape, axes, devices=(META,))


# ---------------------------------------------------------------------------
# pure functions: exact equality with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    got = build_model(get_config(arch)).input_specs(SHAPES[shape])
    want = ref_build_model(ref_get_config(arch)).input_specs(REF_SHAPES[shape])
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device == META
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_rules_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in SHAPES:
        assert lib.cell_skip_reason(cfg, SHAPES[shape]) == ref_lib.cell_skip_reason(
            rcfg, REF_SHAPES[shape])
    assert lib._serving_fsdp(cfg) == ref_lib._serving_fsdp(rcfg)
    for k in (1, 2, 3):
        got, r = lib.probe_config(cfg, k)
        want, rr = ref_lib.probe_config(rcfg, k)
        assert r == rr
        for field in ("num_layers", "encoder_layers", "moe_first_dense", "unroll_layers"):
            assert getattr(got, field) == getattr(want, field)
        assert [(tuple((x.mixer, x.mlp) for x in s.period), s.repeats)
                for s in got.segments()] == [
            (tuple((x.mixer, x.mlp) for x in s.period), s.repeats) for s in want.segments()]


VARIANTS = ["baseline", "nb16", "sp", "dus", "hdus", "dec", "dus+dec", "hoist", "pb4",
            "remat_dots", "moeg512", "cf1.5", "flash", "sp+nb16+hoist+pb2+remat_none"]


@pytest.mark.parametrize("name", VARIANTS + ["bogus"])
def test_variant_kwargs_match_reference(name):
    if name == "bogus":
        with pytest.raises(KeyError):
            ref_perf.variant_kwargs(name)
        with pytest.raises(KeyError):
            perf.variant_kwargs(name)
        return
    assert perf.variant_kwargs(name) == ref_perf.variant_kwargs(name)


# ---------------------------------------------------------------------------
# records held to the reference's compiled ones
# ---------------------------------------------------------------------------

#: output leaves of each cell's step: XLA's output buffer is a tuple whose
#: index table holds 8 bytes per leaf, counted in ``output_size_in_bytes``
TUPLE_ENTRY = 8


def _output_leaves(arch: str, kind: str) -> int:
    model = build_model(get_smoke_config(arch))
    cache = model.init_cache(1, 8, device=META)
    params = tree_leaves(model.init(None, device=META))
    if kind == "train":  # params, AdamW's step and two moments, the loss
        return 3 * len(params) + 2
    return 1 + len(tree_leaves(cache))  # logits and the cache


@pytest.mark.parametrize("arch", ref_child.ARCHES)
@pytest.mark.parametrize("shape", ref_child.SHAPE_NAMES)
def test_memory_matches_reference(reference, small_shapes, arch, shape):
    rec = lib.run_cell(arch, shape, _meta_mesh(), mesh_label="test",
                       overrides=ref_child.overrides(get_smoke_config(arch)))
    want = reference[(arch, shape, "run")]["memory"]
    got = rec["memory"]
    kind = SHAPES[shape].kind
    # XLA's tuple table: the port's outputs are the leaves themselves
    assert got["output_bytes"] + TUPLE_ENTRY * _output_leaves(arch, kind) == want["output_bytes"]
    arg, alias = got["argument_bytes"], got["alias_bytes"]
    if arch == "mamba2-1.3b" and kind == "prefill":
        # the reference's prefill never reads the SSM state it is given (h is
        # computed from zeros) and XLA drops that unused donated parameter:
        # its shard leaves both the arguments and the aliases
        model = build_model(get_smoke_config(arch))
        cache = model.init_cache(SHAPES[shape].global_batch, SHAPES[shape].seq_len,
                                 device=META)
        h = cache["seg0"][0]["h"]
        h_shard = h.numel() * 4 // 8  # batch over data (2), heads over model (4)
        arg, alias = arg - h_shard, alias - h_shard
    if arch == "mamba2-1.3b" and kind == "decode":
        arg -= 4  # no mamba2 layer reads the decode position: XLA drops the int32 scalar
    assert arg == want["argument_bytes"]
    assert alias == want["alias_bytes"]
    assert got["temp_bytes"] == 0 and got["temp_bytes_counted"] is False
    assert got["peak_live_bytes"] == got["argument_bytes"] + got["output_bytes"] - got[
        "alias_bytes"]


#: The port's FLOPs are matrix products (FlopCounterMode's formulas) and its
#: kernels' formulas; XLA's ``cost_analysis`` adds a FLOP per element of
#: every elementwise operation and reduction, so the two are not comparable.
#: The products themselves are: the child sums ``2·M·N·K`` over the ``dot``
#: instructions of each compiled module (``dot_flops``).  Every cell is
#: compared on the data-parallel ``DATA_MESH``, where a device's products
#: are one rank's; and the cells that run the tensor-parallel rank program
#: (the serving cells) on the (2, 4) mesh too, where XLA's GSPMD partition
#: and the port's rank program split the same products four ways and repeat
#: the same one on every model position: the decode step's k and v
#: projections of the new token, whose 2 kv heads do not divide 4; mamba2's
#: B/C products XLA splits and the rank program does not, and MLA's K/V
#: decompression and the vlm's memory projection, which the two split
#: differently, by closed forms.
#: The dense, SSM, hybrid and MoE families' train cells run the
#: tensor-parallel train program and are compared on (2, 4) too, their
#: gaps to XLA's partition in closed form (:func:`_train_apart`); on
#: ``DATA_MESH`` over the one-rank model axis the same function gives the
#: recomputed period's last product and the four SSD gradient contractions
#: XLA forms as dots (16384 FLOPs each at mamba2's widths).  1 %: a lost
#: LM head, layer or batch share is far more.
DOT_RTOL = 0.01


@pytest.mark.parametrize("arch", ref_child.ARCHES)
@pytest.mark.parametrize("shape", ref_child.SHAPE_NAMES)
def test_flops_held_to_reference(reference, small_shapes, monkeypatch, arch, shape):
    """The port's matrix-product FLOPs of a cell's step equal the products
    of the reference's compiled module, within :data:`DOT_RTOL`.  The SSD
    kernel's formula counts the kernel's own work (64-row chunks, products
    split in two; held to a closed form below), so here the port's plain
    chunked SSD, the reference model's own algorithm, takes its place.  A
    train cell runs the tensor-parallel train program over the one-rank
    model axis, whose recomputation runs the period's last product too
    (:func:`_train_apart` at one model rank)."""
    monkeypatch.setattr(ops, "ssd_scan", ss.ssd_chunked)
    mesh = compat_make_mesh(*ref_child.DATA_MESH, devices=(META,))
    cfg = get_smoke_config(arch)
    rec = lib.run_cell(arch, shape, mesh, mesh_label="data", overrides=ref_child.overrides(cfg))
    assert rec["cost"]["kernels"] == {}
    want = reference[(arch, shape, "data")]["cost"]["dot_flops"]
    assert want > 0
    got = rec["cost"]["flops"]
    tensor_parallel = build_model(cfg).tensor_parallel_training_refusal() is None
    if SHAPES[shape].kind == "train" and tensor_parallel:
        got += _train_apart(cfg, SHAPES[shape], model_ranks=1)
    assert got == pytest.approx(want, rel=DOT_RTOL)


TP_CELLS = [("qwen3-32b", "train_4k"), ("qwen3-32b", "prefill_32k"), ("qwen3-32b", "decode_32k"),
            ("mamba2-1.3b", "train_4k"), ("mamba2-1.3b", "prefill_32k"),
            ("mamba2-1.3b", "decode_32k"), *ref_child.TP_CELLS]


def _rank_rows(shape: ShapeCell) -> int:
    """A rank's batch rows on the (2, 4) mesh in one traced body: half the
    batch, split over data (of a train cell, half of one of its 4
    microbatch blocks); the whole batch of one of a ``long_500k`` cell
    (``long_decode_rules`` replicates it)."""
    if shape.name == "long_500k":
        return shape.global_batch
    return shape.global_batch // (4 if shape.kind == "train" else 1) // 2


def _train_apart(cfg, shape: ShapeCell, model_ranks: int = 4, data_ranks: int = 2) -> int:
    """The products of one traced train body (one period, one microbatch
    block, the rank's T tokens) that XLA's partition computes beyond the
    tensor-parallel train program's, on the (2, 4) mesh (negative where the
    rank program computes more).

    * Under ``remat="full"`` the rank program recomputes a period whole,
      its last product too, whose output no backward reads and which XLA's
      recomputation leaves out: the last layer's ``w_down``
      (``2·T·(d_ff/4)·D``), mamba2's ``w_out`` (``2·T·(din/4)·D``) or the
      experts' combine of the rank's rows (``2·T·(E/4)·C·D``, C the
      per-expert capacity).
    * Where the kv heads do not divide the model axis (qwen3's 2 over 4,
      ``wk``/``wv`` replicated), the rank program projects k and v for its
      T/4 sequence rows with every kv head, in the forward, the
      recomputation and the two gradient products each:
      ``8·2·(T/4)·D·Hkv·Dh``.  XLA projects k with every kv head and v
      with the r kv heads the rank's q heads read, in the forward and the
      recomputation (``2·2·T·D·Dh·(Hkv + r)``); in the backward it forms
      their input gradients at that width (``2·T·D·Dh·(Hkv + r)``) and
      their weight gradients over the rank's D/2 ``fsdp`` rows
      (``2·T·(D/2)·Dh·(Hkv + r)``).
    * Per mamba2 layer the rank program computes whole what XLA splits four
      ways, in the forward, the recomputation and the two gradient products
      each: the B and C projections of the replicated ``w_in_b``/``w_in_c``
      (``2·T·D·N`` each) and, on the chunked route, the ``C·Bᵀ`` every
      head shares (``2·T·q·N``, q the chunk); and XLA forms four of the
      SSD's gradient contractions as dots, over the rank's heads, two over
      the head dim P and two over the state N (``2·T·(nh/4)·P`` and
      ``2·T·(nh/4)·N`` each), where PyTorch's autograd takes products and
      sums.
    * Per MoE layer whose rank all-gathers the batch's G token rows (G > T):
      the rank program dispatches them all to its E/4 experts and takes the
      input gradient of all G rows (``2·G·(E/4)·C·D``), where XLA takes its
      own T rows'; it combines and differentiates the combine for its own T
      rows, where XLA does the forward, the output's and the combine
      weights' gradients for all G (``3·2·(G − T)·(E/4)·C·D`` more on XLA's
      side); XLA keeps the experts' D over ``fsdp`` in eight of their
      twelve products (``w_down``'s forward, recomputation and both
      gradients, the input gradients through ``w_gate``/``w_up`` and their
      weight gradients: ``2·(E/4)·C·F·D/2`` each), where the rank gathers
      them whole; and the rank program forms the combine weights' gradient
      as a product over the k choices (``2·G·k·(E/4)·C``), XLA as products
      and sums."""
    from repro_torch.models.moe import _groups

    t = _rank_rows(shape) * shape.seq_len
    d, dh, hkv, h = cfg.d_model, cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    segments = lib._scan_bodies(cfg).segments()
    layers = [s for seg in segments for s in seg.period]
    m = model_ranks
    din = cfg.ssm_expand * cfg.d_model
    ev, k = cfg.moe_experts * cfg.moe_virtual_split, cfg.moe_top_k * cfg.moe_virtual_split
    g, cap = _groups(cfg, t * data_ranks) if cfg.moe_experts else (t, 0)
    held = ev // m if ev % m == 0 else ev
    apart = 0
    if cfg.remat == "full":
        for seg in segments:
            last = seg.period[-1]
            if last.mlp == "dense":
                apart -= 2 * t * ((cfg.dense_d_ff or cfg.d_ff) // m) * d
            elif last.mlp == "moe":
                apart -= 2 * t * held * cap * d
            elif last.mixer == "mamba2":
                apart -= 2 * t * (din // m) * d
    if hkv and hkv % m:
        read = max(h // m // (h // hkv), 1)
        xla = (2 * 2 * t * d * dh * (hkv + read) + 2 * t * d * dh * (hkv + read)
               + 2 * t * (d // data_ranks) * dh * (hkv + read))
        mine = 8 * 2 * (t // m) * d * hkv * dh
        apart += sum(s.mixer == "attn" for s in layers) * (xla - mine)
    n, nh, p = cfg.ssm_state, din // cfg.ssm_head_dim if cfg.ssm_head_dim else 0, cfg.ssm_head_dim
    chunked = shape.seq_len > cfg.ssm_chunk and shape.seq_len % cfg.ssm_chunk == 0
    whole = 4 * (2 * 2 * t * d * n + (2 * t * cfg.ssm_chunk * n if chunked else 0))
    ssd_dots = 4 * t * (nh // m) * (p + n) if chunked else 0
    apart += sum(s.mixer == "mamba2" for s in layers) * (ssd_dots - whole * (m - 1) // m)
    if g > t:
        f = cfg.moe_d_ff // cfg.moe_virtual_split
        moe = (3 * 2 * (g - t) * held * cap * d - 2 * (g - t) * held * cap * d
               - 8 * 2 * held * cap * f * d * (data_ranks - 1) // data_ranks
               - 2 * g * k * held * cap)
        apart += sum(s.mlp == "moe" for s in layers) * moe
    return apart


def _whole_on_every_rank(cfg, shape: ShapeCell, model_ranks: int = 4) -> int:
    """The products GSPMD splits over ``model`` and the rank program
    computes whole, beyond XLA's share of them, in one scan body of a cell
    on the (2, 4) mesh: per mamba2 layer the B and C projections of the
    replicated ``w_in_b``/``w_in_c`` (``2·rows·L·D·N`` each) and, on the
    chunked route, the ``C·Bᵀ`` that every head shares (``2·rows·L·q·N``),
    of which XLA computes a quarter on each device.  The MoE router, whole
    on both sides, is not among them.  A train cell's are in
    :func:`_train_apart`."""
    if shape.kind == "train":
        return 0
    rows = _rank_rows(shape)
    tokens = rows * (shape.seq_len if shape.kind == "prefill" else 1)
    layers = sum(s.mixer == "mamba2" for seg in lib._scan_bodies(cfg).segments()
                 for s in seg.period)
    chunked = shape.kind == "prefill" and shape.seq_len > cfg.ssm_chunk
    per_layer = 2 * 2 * tokens * cfg.d_model * cfg.ssm_state
    per_layer += 2 * tokens * cfg.ssm_chunk * cfg.ssm_state if chunked else 0
    return layers * per_layer * (model_ranks - 1) // model_ranks


def _split_apart(cfg, shape: ShapeCell, model_ranks: int = 4) -> int:
    """The products a device of GSPMD's partition computes beyond the rank
    program's share of them, in one scan body of a prefill cell on the
    (2, 4) mesh.  Per MLA layer the decompression of the latent into K and
    V (``c_kv·wk_b`` and ``c_kv·wv_b``, ``2·rows·L·Kr·H·Dh`` each): XLA
    forms them for every head on every device, the rank program for its
    heads.  Per cross layer whose kv heads the model axis does not divide
    (the vlm's 2 over 4), the memory projections (``memory·wk_mem`` and
    ``memory·wv_mem``, ``2·rows·M·Dm·Hkv·Dh`` each): XLA splits them by
    kv head (one of the 2 a device), the rank program by the memory rows
    (a quarter each).  A decode step's products agree (the MLA layers'
    down-projections and the new token's latent whole on both sides, the
    cross layers' memory read from the cache) but in a ``long_500k`` cell,
    where the cache holds every kv head of its rows: per attention layer
    whose kv heads the model axis does not divide (jamba's and mixtral's 2
    over 4), XLA projects the new token's v (``x·wv``, ``2·B·D·Dh`` a kv
    head) for the kv heads its device's q heads read, the rank program for
    every kv head, and the difference is negative.  A train cell's:
    :func:`_train_apart`."""
    if shape.kind == "train":
        return _train_apart(cfg, shape)
    body = [s.mixer for seg in lib._scan_bodies(cfg).segments() for s in seg.period]
    h, dh, hkv = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads
    if shape.name == "long_500k":
        if not hkv or hkv % model_ranks == 0:
            return 0
        read = max(h // model_ranks // (h // hkv), 1)  # the kv heads a rank's q heads read
        return -body.count("attn") * 2 * shape.global_batch * cfg.d_model * (hkv - read) * dh
    if shape.kind != "prefill":
        return 0
    rows = _rank_rows(shape)
    mla = 2 * 2 * rows * shape.seq_len * cfg.kv_lora_rank * h * dh
    apart = body.count("mla") * mla * (model_ranks - 1) // model_ranks
    if hkv % model_ranks:
        mem = 2 * 2 * rows * cfg.image_tokens * cfg.image_embed_dim * hkv * dh
        apart += body.count("cross_attn") * (mem // hkv - mem // model_ranks)
    return apart


@pytest.mark.parametrize("arch,shape", TP_CELLS)
def test_tensor_parallel_flops_held_to_reference(reference, small_shapes, monkeypatch, arch,
                                                 shape):
    """The tensor-parallel rank program's matrix-product FLOPs on the (2, 4)
    mesh equal the products of one device's GSPMD-partitioned module
    (``mesh_label="test"``): every product split four ways (heads, SSM
    heads, MLP columns, experts, vocabulary, the prompt's k/v rows or kv
    heads, the context-parallel decode attention); qwen3's and mixtral's
    new-token k/v projections of their 2 replicated kv heads whole on both
    sides, and the MoE layers' router and dispatch over the batch's one
    group on both sides, each returning its own rows.  Where the two
    partition a product differently, the difference is its closed form:
    mamba2's replicated B/C products (:func:`_whole_on_every_rank`), and
    MLA's K/V decompression and the vlm's replicated memory projection,
    and a ``long_500k`` decode step's v projection of the new token
    (:func:`_split_apart`).  The ``long_500k`` cells (a batch of one under
    ``long_decode_rules``, its cache's rows over data) attend with the
    rank's heads to its rows on both sides.  Whisper's encoder, decoder and cross layers
    (their heads split 1 a rank), deepseek-v2's MLA heads, its
    down-projections by the prompt's rows, experts and shared experts and
    the vlm's attention layers split alike.  The dense train cells
    (qwen3-32b, deepseek-7b) run the tensor-parallel train program: the
    forward, the recomputed period and the backward split four ways, the
    loss from the rank's vocabulary block on both sides.  As in the
    data-parallel comparison, the plain chunked SSD takes the kernel's
    place."""
    monkeypatch.setattr(ops, "ssd_scan", ss.ssd_chunked)
    mesh = _meta_mesh()
    cfg = get_smoke_config(arch)
    rec = lib.run_cell(arch, shape, mesh, mesh_label="test", overrides=ref_child.overrides(cfg))
    program = "tensor_parallel_train" if SHAPES[shape].kind == "train" else "tensor_parallel"
    assert rec["cost_basis"].startswith(lib.COST_BASIS[program])
    assert rec["collectives_basis"] == lib.COLLECTIVES_BASIS[program]
    want = reference[(arch, shape, "run")]["cost"]["dot_flops"]
    assert want > 0
    assert rec["cost"]["flops"] - _whole_on_every_rank(cfg, SHAPES[shape]) + _split_apart(
        cfg, SHAPES[shape]) == want


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_tensor_parallel_ssd_cost_counts_the_ranks_heads(small_shapes, arch):
    """The SSD kernel's formula in a tensor-parallel prefill cell: one call
    per mamba2 layer of the scan body, at the rank's rows and its quarter of
    the heads; the long-context cell runs the tensor-parallel rank program
    too (``long_decode_rules``)."""
    cfg = get_smoke_config(arch)
    ov = ref_child.overrides(cfg)
    mesh = _meta_mesh()
    rec = lib.run_cell(arch, "prefill_32k", mesh, mesh_label="test", overrides=ov)
    shape = SHAPES["prefill_32k"]
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    x = torch.empty((shape.global_batch // 2, shape.seq_len, nh // 4, cfg.ssm_head_dim),
                    dtype=torch.bfloat16, device=META)
    bm = torch.empty((x.shape[0], shape.seq_len, cfg.ssm_state), dtype=torch.bfloat16,
                     device=META)
    _, flops, nbytes = ss.ssd_cost(x, bm)
    layers = sum(s.mixer == "mamba2" for seg in lib._scan_bodies(cfg).segments()
                 for s in seg.period)
    assert rec["cost"]["kernels"]["ssd_scan"] == {"calls": layers, "flops": layers * flops,
                                                  "bytes": layers * nbytes}
    long = lib.run_cell(arch, "long_500k", mesh, mesh_label="test", overrides=ov)
    assert long["cost_basis"].startswith(lib.COST_BASIS["tensor_parallel"])


@pytest.mark.parametrize("impls,heads_attended", [(("masked", "decomposed"), 4),
                                                   (("heads_dus", "heads_dus+decomposed"), 1)])
def test_decomposed_decode_cell_counts_the_new_row(small_shapes, impls, heads_attended):
    """The ``dec`` variant of qwen3's tensor-parallel decode cell is not the
    baseline's program: beside the same cache attention every rank scores
    the new token, a product of 2·B/2·H·Dh FLOPs over the q heads it
    attends with (every head under the ``seq`` cache's context-parallel
    combine, its quarter under ``heads``; weighing the new value contracts
    one row, an elementwise product the counter leaves out), and reads more
    bytes; its collectives are the baseline's."""
    mesh = _meta_mesh()
    cfg = get_smoke_config("qwen3-32b")
    ov = ref_child.overrides(cfg)
    base, dec = (lib.run_cell("qwen3-32b", "decode_32k", mesh, mesh_label="test", overrides=ov,
                              cache_impl=impl)
                 for impl in impls)
    assert dec["cost_basis"] == base["cost_basis"]
    assert base["cost_basis"].startswith(lib.COST_BASIS["tensor_parallel"])
    rows = SHAPES["decode_32k"].global_batch // 2
    new_row = 2 * rows * heads_attended * cfg.resolved_head_dim
    assert dec["cost"]["flops"] - base["cost"]["flops"] == new_row
    assert dec["cost"]["bytes_accessed"] > base["cost"]["bytes_accessed"]
    assert dec["collectives"] == base["collectives"]


def _serving_census(shape_name: str, layers: int) -> dict:
    cfg = lib.probe_config(get_smoke_config("qwen3-32b"), layers)[0]
    return lib.lower_cell(cfg, _meta_mesh(), SHAPES[shape_name]).trace()["collectives"]


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_serving_census_holds_the_model_all_reduces(small_shapes, shape_name):
    """qwen3's serving census on the (2, 4) mesh at 1, 2 and 5 unrolled
    layers, against a closed form in the layer count L (bf16 activations
    of the rank's B/2 rows, f32 softmax partials): the embedding's psum,
    then per layer the psums after wo and w_down; the prefill all-gathers
    the replicated kv heads' k and v rows (the cache's S/4 rows each
    rank projects); a decode step all-gathers the q heads and combines the
    context-parallel attention with a pmax and one psum."""
    cfg = get_smoke_config("qwen3-32b")
    shape = SHAPES[shape_name]
    rows = shape.global_batch // 2
    d, dh, hkv = cfg.d_model, cfg.resolved_head_dim, cfg.num_kv_heads
    h = cfg.num_heads
    for layers in (1, 2, 5):
        census = _serving_census(shape_name, layers)
        if shape.kind == "prefill":
            act = rows * shape.seq_len * d * 2
            reduces, reduce_bytes = 1 + 2 * layers, (1 + 2 * layers) * act
            gathers = 2 * layers
            gather_bytes = gathers * rows * (shape.seq_len // 4) * hkv * dh * 2
        else:
            act = rows * d * 2
            partials = rows * h * 4 * (1 + 1 + dh)  # the max, the sum and the output
            reduces = 1 + 4 * layers
            reduce_bytes = (1 + 2 * layers) * act + layers * partials
            gathers, gather_bytes = layers, layers * rows * (h // 4) * dh * 2
        assert census["counts"] == {"all-reduce": reduces, "all-gather": gathers}
        assert census["operand_bytes"] == {"all-reduce": reduce_bytes,
                                           "all-gather": gather_bytes}


def test_dot_flops_counts_a_compiled_module():
    """The child's census of a module's products: a batched product and a
    plain one, counted by hand."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a, b, c: jnp.einsum("bij,bjk->bik", a, b).sum() + (a[0] @ c).sum())
    text = f.lower(jnp.ones((3, 4, 5)), jnp.ones((3, 5, 6)), jnp.ones((5, 7))).compile().as_text()
    assert ref_child.dot_flops(text) == 2 * 3 * 4 * 6 * 5 + 2 * 4 * 7 * 5


@pytest.mark.parametrize("arch", ref_child.ARCHES)
@pytest.mark.parametrize("shape", ref_child.SHAPE_NAMES)
def test_probe_keeps_the_reference_keys(reference, small_shapes, arch, shape):
    ref_probe = reference.get((arch, shape, "probe"))
    prb = lib.probe_cell(arch, shape, _meta_mesh(), mesh_label="test",
                         overrides=ref_child.overrides(get_smoke_config(arch)))
    assert set(prb) >= {"depths", "repeats", "extrapolated", "probe_s"}
    if ref_probe is not None:
        assert prb["repeats"] == ref_probe["repeats"]
        assert set(prb["extrapolated"]) == set(ref_probe["extrapolated"])


def _split(records):
    """(the run records, the probe records), as roofline.analyze takes them."""
    return ([r for r in records if "memory" in r or r["status"] == "SKIP"],
            [r for r in records if "extrapolated" in r])


def test_roofline_reads_the_reference_records_as_the_reference(reference):
    from repro.analysis.roofline import analyze as ref_analyze
    from repro.analysis.roofline import to_markdown as ref_to_markdown
    from repro_torch.analysis.roofline import TPU_V5E, analyze, to_markdown

    # model_flops reads the registry's configs and SHAPES (unpatched here) in
    # both packages, so both analyses see the same model terms
    rows = analyze(*_split(list(reference.values())), TPU_V5E)
    assert rows == ref_analyze(*_split(list(reference.values())))
    assert to_markdown(rows) == ref_to_markdown(rows)


def test_roofline_reads_the_port_records(small_shapes):
    from repro_torch.analysis.roofline import analyze

    mesh = _meta_mesh()
    mine = []
    for arch in ref_child.ARCHES:
        ov = ref_child.overrides(get_smoke_config(arch))
        mine.append(lib.run_cell(arch, "decode_32k", mesh, mesh_label="test", overrides=ov))
        mine.append(lib.probe_cell(arch, "decode_32k", mesh, mesh_label="test", overrides=ov))
    rows = analyze(*_split(mine))
    assert [r["status"] for r in rows] == ["OK", "OK"]
    assert all(r["dominant"] in ("compute", "memory", "collective") for r in rows)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ref_child.SHAPE_NAMES)
def test_depth_fit_equals_full_depth_count(small_shapes, shape):
    """qwen3's smoke config at 5 layers: the k = 1, 2 fit of the unrolled
    traces equals the full unrolled depth counted directly."""
    ov = dict(ref_child.overrides(get_smoke_config("qwen3-32b")), num_layers=5)
    mesh = _meta_mesh()
    prb = lib.probe_cell("qwen3-32b", shape, mesh, mesh_label="test", overrides=ov)
    assert prb["repeats"] == 5
    cfg = dataclasses.replace(get_smoke_config("qwen3-32b"), **ov)
    full = lib._probe_metrics(lib.probe_config(cfg, 5)[0], mesh, SHAPES[shape])
    fit = prb["extrapolated"]
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        assert fit[key] == full[key], key
    assert fit["collective_by_kind"] == full["collective_by_kind"]
    assert full["flops"] > prb["depths"]["2"]["flops"] > prb["depths"]["1"]["flops"] > 0


def test_train_census_counts_the_gathers_and_the_gradient_sum(small_shapes):
    """whisper-tiny's smoke train cell, which the tensor-parallel train
    program refuses (its encoder), so the cell runs the data-parallel
    program: one all-gather per sharded dim of every param leaf (shard bytes
    in, the gathered dim's bytes out) and one psum of the loss and the f32
    gradients, by hand from the layouts."""
    mesh = _meta_mesh()
    cfg = get_smoke_config("whisper-tiny")
    assert build_model(cfg).tensor_parallel_training_refusal() is not None
    rec = lib.run_cell("whisper-tiny", "train_4k", mesh, mesh_label="test",
                       overrides=ref_child.overrides(cfg))
    assert rec["collectives_basis"] == lib.COLLECTIVES_BASIS["data_parallel"]
    params = build_model(lib._scan_bodies(cfg)).init(None, device=META, master=True)
    shardings = lib.params_shardings(params, mesh, fsdp_axis="data")
    gathers = operand = result = 0
    for leaf, sh in zip(tree_leaves(params), tree_leaves(shardings)):
        shape = list(sh.shard_shape(tuple(leaf.shape)))
        for d, e in enumerate(sh.spec):
            if e is not None:
                gathers += 1
                operand += math.prod(shape) * 4
                shape[d] = leaf.shape[d]
                result += math.prod(shape) * 4
    grads = 4 + sum(leaf.numel() * 4 for leaf in tree_leaves(params))
    assert rec["collectives"]["counts"] == {"all-gather": gathers, "all-reduce": 1}
    assert rec["collectives"]["operand_bytes"] == {"all-gather": operand, "all-reduce": grads}
    assert rec["collectives"]["result_bytes"] == {"all-gather": result, "all-reduce": grads}


def test_tensor_parallel_train_census_by_hand(small_shapes):
    """qwen3's smoke train cell on the (2, 4) mesh (one period, one block of
    the rank's T = 2 × 32 tokens, ``remat="full"``; its 2 kv heads
    replicated over the 4-way model axis), the census by hand from the
    layouts: the ``fsdp`` gathers over data, one per param leaf with a data
    dim; the forward's all-reduces (the embedding's, after wo and w_down,
    the loss's row max and its pair of sums) and the two all-gathers of the
    k and v rows; the recomputed period's all-reduces and all-gathers again;
    the backward's transposes: an all-reduce for each value every model
    rank holds alike that enters its share (the head's, the MLP's and the
    attention's input, q_norm, k_norm, wk and wv), a reduce-scatter for
    each all-gather; the gradients' reduce-scatter over data per data dim,
    an all-reduce over data of each leaf without one and of the loss, and
    the clip norm's all-reduce."""
    mesh = _meta_mesh()
    cfg = get_smoke_config("qwen3-32b")
    rec = lib.run_cell("qwen3-32b", "train_4k", mesh, mesh_label="test",
                       overrides=ref_child.overrides(cfg))
    assert rec["collectives_basis"] == lib.COLLECTIVES_BASIS["tensor_parallel_train"]
    shape = SHAPES["train_4k"]
    rows, seq, d, dh, hkv = 2, shape.seq_len, cfg.d_model, cfg.resolved_head_dim, cfg.num_kv_heads
    act = rows * seq * d * 2  # a bf16 (rows, S, D) activation
    kv_rows = rows * (seq // 4) * hkv * dh * 2  # a rank's bf16 k or v rows, every kv head
    params = build_model(lib._scan_bodies(cfg)).init(None, device=META, master=True)
    shardings = lib.params_shardings(params, mesh, fsdp_axis="data")
    fsdp = [(leaf, sh) for leaf, sh in zip(tree_leaves(params), tree_leaves(shardings))
            if any(e == "data" for e in sh.spec)]
    whole = [leaf for leaf, sh in zip(tree_leaves(params), tree_leaves(shardings))
             if all(e != "data" for e in sh.spec)]
    mixer = params["seg0"][0]["mixer"]
    gathered = [math.prod(sh.shard_shape(tuple(leaf.shape))) * 2 * 4 for leaf, sh in fsdp]
    shard = [math.prod(sh.shard_shape(tuple(leaf.shape))) * 4 for leaf, sh in fsdp]
    forward = [act, act, act, rows * seq * 4, 2 * rows * seq * 4]  # embed, wo, w_down, loss
    recomputed = [act, act]
    transposes = [act, act, act] + [mixer[k].numel() * 4 for k in ("q_norm", "k_norm", "wk",
                                                                    "wv")]
    sums = [leaf.numel() * 4 for leaf in whole] + [4, 4]  # replicated leaves, the loss, the norm
    assert rec["collectives"]["counts"] == {
        "all-gather": len(fsdp) + 4, "reduce-scatter": 2 + len(fsdp),
        "all-reduce": len(forward) + len(recomputed) + len(transposes) + len(sums)}
    assert rec["collectives"]["operand_bytes"] == {
        "all-gather": sum(shard) + 4 * kv_rows, "reduce-scatter": 2 * 4 * kv_rows + sum(gathered),
        "all-reduce": sum(forward) + sum(recomputed) + sum(transposes) + sum(sums)}
    assert rec["collectives"]["result_bytes"]["all-gather"] == sum(gathered) + 4 * 4 * kv_rows
    assert rec["collectives"]["result_bytes"]["reduce-scatter"] == 2 * kv_rows + sum(shard)


def test_tensor_parallel_train_census_by_hand_ssm(small_shapes):
    """mamba2's smoke train cell on the (2, 4) mesh (one period of one
    mamba2 layer, one block of the rank's T = 2 × 32 tokens,
    ``remat="full"``; its 8 SSM heads 2 a rank), the census by hand from
    the layouts: the ``fsdp`` gathers over data, one per param leaf with a
    data dim; the forward's all-reduces (the embedding's, the gated norm's
    f32 sum of squares and ``w_out``'s partial, the loss's row max and its
    pair of sums); the recomputed period's two again; the backward's
    transposes: an all-reduce for each value every model rank holds alike
    that enters its share (the mixer's input, ``w_in_b``, ``w_in_c``,
    ``conv_b``, ``conv_c``, the norm's sum of squares, the head's input);
    the gradients' reduce-scatter over data per data dim, an all-reduce
    over data of each leaf without one and of the loss, and the clip norm's
    all-reduce.  No all-gather inside the step: training runs no cache."""
    mesh = _meta_mesh()
    cfg = get_smoke_config("mamba2-1.3b")
    rec = lib.run_cell("mamba2-1.3b", "train_4k", mesh, mesh_label="test",
                       overrides=ref_child.overrides(cfg))
    assert rec["collectives_basis"] == lib.COLLECTIVES_BASIS["tensor_parallel_train"]
    rows, seq, d = 2, SHAPES["train_4k"].seq_len, cfg.d_model
    act = rows * seq * d * 2  # a bf16 (rows, S, D) activation
    sumsq = rows * seq * 4  # the gated norm's f32 sum of squares, one a token
    params = build_model(lib._scan_bodies(cfg)).init(None, device=META, master=True)
    shardings = lib.params_shardings(params, mesh, fsdp_axis="data")
    fsdp = [(leaf, sh) for leaf, sh in zip(tree_leaves(params), tree_leaves(shardings))
            if any(e == "data" for e in sh.spec)]
    no_data = [math.prod(sh.shard_shape(tuple(leaf.shape))) * 4
               for leaf, sh in zip(tree_leaves(params), tree_leaves(shardings))
               if all(e != "data" for e in sh.spec)]  # the rank's shard, summed over data
    mixer = params["seg0"][0]["mixer"]
    gathered = [math.prod(sh.shard_shape(tuple(leaf.shape))) * 2 * 4 for leaf, sh in fsdp]
    shard = [math.prod(sh.shard_shape(tuple(leaf.shape))) * 4 for leaf, sh in fsdp]
    forward = [act, sumsq, act, rows * seq * 4, 2 * rows * seq * 4]  # embed, norm, w_out, loss
    recomputed = [sumsq, act]
    alike = [mixer[k].numel() * 4 for k in ("w_in_b", "w_in_c", "conv_b", "conv_c")]
    transposes = [act, sumsq, act] + alike  # the mixer's input, the norm, the head's input
    sums = no_data + [4, 4]  # the leaves without a data dim, the loss, the clip norm
    assert rec["collectives"]["counts"] == {
        "all-gather": len(fsdp), "reduce-scatter": len(fsdp),
        "all-reduce": len(forward) + len(recomputed) + len(transposes) + len(sums)}
    assert rec["collectives"]["operand_bytes"] == {
        "all-gather": sum(shard), "reduce-scatter": sum(gathered),
        "all-reduce": sum(forward) + sum(recomputed) + sum(transposes) + sum(sums)}
    assert rec["collectives"]["result_bytes"]["all-gather"] == sum(gathered)
    assert rec["collectives"]["result_bytes"]["reduce-scatter"] == sum(shard)


@pytest.mark.parametrize("name", VARIANTS)
def test_every_variant_component_runs(small_shapes, monkeypatch, name):
    """Each variant runs through the port's run_cell and probe_cell as the
    perf script calls them, on the smoke configs that exercise it (16
    blocks: 64 rows, two for each of the 2 data-parallel ranks)."""
    monkeypatch.setitem(SHAPES, "train_4k", ShapeCell("train_4k", "train", 32, 64))
    kw, probe_only = perf.variant_kwargs(name)
    arch = "mixtral-8x7b" if {"moeg512", "cf1.5"} & set(name.split("+")) else "qwen3-32b"
    shape = "decode_32k" if {"dus", "hdus", "dec"} & set(name.split("+")) else "train_4k"
    if name == "flash":
        shape = "prefill_32k"
    ov = dict(ref_child.overrides(get_smoke_config(arch)), **kw.pop("overrides", {}))
    mesh = _meta_mesh()
    rec = lib.run_cell(arch, shape, mesh, mesh_label="test", overrides=ov, **kw)
    pkw = {k: v for k, v in kw.items() if k != "num_blocks"}
    prb = lib.probe_cell(arch, shape, mesh, mesh_label="test", overrides=ov, **pkw,
                         **probe_only)
    assert rec["status"] == prb["status"] == "OK"
    assert prb["extrapolated"]["flops"] > 0
    if name == "flash":
        assert rec["cost"]["kernels"]["flash_attention"]["calls"] == 1


def _flash_inputs(dtype, d, lq=40, lk=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((2, lq, 4, d), generator=g).to(dtype)
    k = torch.randn((2, lk, 2, d), generator=g).to(dtype)
    return q, k, torch.randn((2, lk, 2, d), generator=g).to(dtype)


@pytest.mark.parametrize("causal,window,lq,lk", [(True, 0, 40, 40), (False, 0, 24, 56),
                                                 (True, 9, 40, 40), (False, 7, 33, 40),
                                                 (True, 0, 56, 24)])
def test_flash_formula_equals_counted_mask(causal, window, lq, lk):
    """4·D per kept pair: the kept pairs counted from the plain version's
    own mask rule."""
    q, k, v = _flash_inputs(torch.float32, 16, lq, lk)
    qpos, kpos = np.arange(lq)[:, None], np.arange(lk)[None, :]
    mask = np.ones((lq, lk), dtype=bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    name, flops, nbytes = fa.flash_cost(q, k, causal=causal, window=window)
    b, _, h, d = q.shape
    assert name == "flash_attention"
    assert flops == 4 * b * h * d * int(mask.sum())
    assert nbytes == sum(t.numel() * 4 for t in (q, k, v, q))


def test_ssd_formula_equals_chunk_products():
    """The kernel's work counted product by product over its 64-row chunks."""
    b, l, nh, p, n = 2, 192, 4, 16, 8
    x = torch.zeros((b, l, nh, p), dtype=torch.bfloat16, device=META)
    bm = torch.zeros((b, l, n), dtype=torch.bfloat16, device=META)
    macs = 0
    for _ in range(b):
        for c in range(l // 64):
            pairs = sum(i + 1 for i in range(64))  # causal half of the chunk
            macs += pairs * n  # C·Bᵀ, shared by the heads
            for _ in range(nh):  # each product's f32 factor as bf16 hi + lo
                macs += 2 * pairs * p          # (decayed C·Bᵀ)·x
                macs += 2 * 64 * n * p         # C·h
                macs += 2 * 64 * p * n         # the state update
    name, flops, nbytes = ss.ssd_cost(x, bm)
    assert (name, flops) == ("ssd_scan", 2 * macs)
    inputs = 2 * (b * l * nh * p + b * l * nh + nh + 2 * b * l * n)
    assert nbytes == inputs + 2 * b * l * nh * p + 4 * b * nh * p * n


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 48), (torch.float32, 24)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_flash_meta_route_matches_cpu_route(dtype, d, causal, window):
    q, k, v = _flash_inputs(dtype, d)
    want = fa.flash_attention(q, k, v, causal=causal, window=window)
    _, cpu = lib.count_cost(fa.flash_attention, q, k, v, causal=causal, window=window)
    got, cost = lib.count_cost(fa.flash_attention, q.to(META), k.to(META), v.to(META),
                               causal=causal, window=window)
    assert got.device == META and got.shape == want.shape and got.dtype == want.dtype
    assert got.stride() == want.stride()
    assert cpu.kernels == {}  # the CPU route's own operations are counted instead
    assert cpu.flops > 0
    calls = {"flash_attention": 1, **({"split_kv": 1} if dtype == torch.float32 else {})}
    assert {k: v["calls"] for k, v in cost.kernels.items()} == calls
    assert cost.flops == fa.flash_cost(q, k, causal=causal, window=window)[1]
    assert fa.flash_attention.launches == 0


def test_ssd_meta_route_matches_cpu_route():
    b, l, nh, p, n = 2, 128, 4, 16, 8
    g = torch.Generator().manual_seed(1)
    x = torch.randn((b, l, nh, p), generator=g)
    dt = torch.rand((b, l, nh), generator=g) * 0.5
    a = -torch.rand((nh,), generator=g) - 0.5
    bm, cm = (torch.randn((b, l, n), generator=g) for _ in range(2))
    y, h = ss.ssd_scan(x, dt, a, bm, cm, chunk=32)
    (ym, hm), cost = lib.count_cost(ss.ssd_scan, *(t.to(META) for t in (x, dt, a, bm, cm)),
                                    chunk=32)
    for got, want in ((ym, y), (hm, h)):
        assert got.device == META and got.shape == want.shape and got.dtype == want.dtype
    assert cost.kernels == {"ssd_scan": dict(zip(("calls", "flops", "bytes"),
                                                 (1, *ss.ssd_cost(x, bm)[1:])))}
    assert ss.ssd_scan.launches == 0


def test_meta_routes_refuse_what_the_card_refuses():
    q, k, v = (t.to(META) for t in _flash_inputs(torch.float64, 64))
    with pytest.raises(ValueError, match="not taken on the card"):
        fa.flash_attention(q, k, v)
    q, k, v = (t.to(META) for t in _flash_inputs(torch.bfloat16, 12))
    with pytest.raises(ValueError, match="not taken on the card"):
        fa.flash_attention(q, k, v)
    x = torch.empty((1, 64, 2, 80), device=META)  # head dim past the kernel's 64
    with pytest.raises(ValueError, match="head dim"):
        ss.ssd_scan(x, torch.empty((1, 64, 2), device=META), torch.empty((2,), device=META),
                    torch.empty((1, 64, 8), device=META), torch.empty((1, 64, 8), device=META),
                    chunk=64)
    w = torch.zeros((2, 8, 4, 16), device=META, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(w, w[:, :, :2], w[:, :, :2])


def test_dryrun_cli_writes_every_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-1.3b",
         "--mesh", "multi_pod", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "== multi_pod: 4 OK / 0 SKIP / 0 FAIL ==" in out.stdout
    with open(tmp_path / "multi_pod.json") as f:
        records = json.load(f)
    assert [r["devices"] for r in records] == [512] * 4
    assert all(r["memory"]["argument_bytes"] > 0 and r["cost"]["flops"] > 0 for r in records)
