"""Reference side of ``tests/test_torch_dryrun.py``, run in one child
process on 8 forced host devices.

The parent sets ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` so
that its own process keeps one device.  This child runs the JAX package's
``run_cell`` and ``probe_cell`` (but for :data:`NO_PROBE`) for every cell
of :data:`ARCHES` × :data:`SHAPE_NAMES` on a (2, 4) ("data", "model") mesh,
then ``run_cell`` for the same cells on the data-parallel
:data:`DATA_MESH`, for :data:`TP_CELLS` on the (2, 4) mesh, and for
:data:`SP_CELLS` there with ``sp=True`` (``train_rules_sp``), at the smoke
configs' widths (passed as ``overrides``)
and the small shape cells of :data:`SMALL_SHAPES` (patched into the shared
``SHAPES`` dict, which only this process sees), and writes the records as
JSON to the path given as its one argument.  Each run record's ``cost``
also holds ``dot_flops``: the matrix products of the compiled module's
text (:func:`dot_flops`).  Not collected by pytest (no ``test_`` prefix).
"""

import dataclasses
import json
import math
import re
import sys

#: the dense-attention and the SSM smoke configs, in each kind of step
ARCHES = ("qwen3-32b", "mamba2-1.3b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
#: name -> (kind, seq_len, global_batch): small cells under the real names
SMALL_SHAPES = {
    "train_4k": ("train", 32, 16),
    "prefill_32k": ("prefill", 32, 8),
    "decode_32k": ("decode", 64, 8),
    "long_500k": ("decode", 64, 1),
}
MESH = ((2, 4), ("data", "model"))
#: no tensor parallelism: the port's own layout, so a device's products are
#: exactly those of one of its ranks
DATA_MESH = ((2, 1), ("data", "model"))
#: cells without a probe: mamba2's train probe alone compiles for 12 s
NO_PROBE = {("mamba2-1.3b", "train_4k")}
#: serving and train cells run on MESH alone (no probe, no DATA_MESH run):
#: the dense config whose kv heads divide the model axis, beside qwen3's
#: that do not; the hybrid and MoE families (mamba2's cells are among
#: ARCHES' runs); MLA, the encoder and cross-attention; the long-context
#: cells of the three
#: sub-quadratic configs (a batch of one under long_decode_rules)
TP_CELLS = (("deepseek-7b", "train_4k"), ("deepseek-7b", "prefill_32k"),
            ("deepseek-7b", "decode_32k"),
            ("jamba-v0.1-52b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"),
            ("jamba-v0.1-52b", "decode_32k"),
            ("mixtral-8x7b", "train_4k"), ("mixtral-8x7b", "prefill_32k"),
            ("mixtral-8x7b", "decode_32k"),
            ("deepseek-v2-236b", "train_4k"), ("deepseek-v2-236b", "prefill_32k"),
            ("deepseek-v2-236b", "decode_32k"),
            ("whisper-tiny", "train_4k"), ("whisper-tiny", "prefill_32k"),
            ("whisper-tiny", "decode_32k"),
            ("llama-3.2-vision-11b", "train_4k"), ("llama-3.2-vision-11b", "prefill_32k"),
            ("llama-3.2-vision-11b", "decode_32k"),
            ("mamba2-1.3b", "long_500k"), ("jamba-v0.1-52b", "long_500k"),
            ("mixtral-8x7b", "long_500k"))
#: train cells run with ``sp=True`` (``train_rules_sp``) on MESH
SP_CELLS = (("qwen3-32b", "train_4k"), ("mamba2-1.3b", "train_4k"))


def overrides(cfg) -> dict:
    """Every field of a smoke config, as ``run_cell``'s ``overrides``."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


_DEF_RE = re.compile(r"%?([\w.\-]+)\s*=\s*\(?[a-z0-9_]+\[([\d,]*)\]")
_DOT_RE = re.compile(r"%?[\w.\-]+\s*=\s*[a-z0-9_]+\[([\d,]*)\]\S*\s+dot\(%?([\w.\-]+),"
                     r".*?lhs_contracting_dims=\{([\d,]*)\}")


def _dims(text: str) -> list[int]:
    return [int(d) for d in text.split(",") if d]


def dot_flops(hlo_text: str) -> int:
    """``2·(output elements)·(contracted size)`` summed over the ``dot``
    instructions of a compiled module's text: its matrix products, each
    instruction once (a ``while`` body's once, as ``cost_analysis`` counts
    it)."""
    shapes = {m.group(1): _dims(m.group(2)) for m in _DEF_RE.finditer(hlo_text)}
    total = 0
    for m in _DOT_RE.finditer(hlo_text):
        lhs = shapes[m.group(2)]
        total += 2 * math.prod(_dims(m.group(1))) * math.prod(lhs[c] for c in _dims(m.group(3)))
    return total


if __name__ == "__main__":
    import jax

    from repro.configs import SHAPES, get_smoke_config
    from repro.configs.base import ShapeCell
    from repro.launch import dryrun_lib
    from repro.launch.mesh import compat_make_mesh

    assert jax.device_count() == 8, jax.device_count()
    for name, (kind, seq, batch) in SMALL_SHAPES.items():
        SHAPES[name] = ShapeCell(name, kind, seq, batch)
    analyze = dryrun_lib.analyze_compiled

    def analyze_with_dots(lowered, compiled):
        rec = analyze(lowered, compiled)
        rec["cost"]["dot_flops"] = dot_flops(compiled.as_text())
        return rec

    dryrun_lib.analyze_compiled = analyze_with_dots
    mesh = compat_make_mesh(*MESH)
    records = []
    for arch in ARCHES:
        ov = overrides(get_smoke_config(arch))
        for shape in SHAPE_NAMES:
            records.append(dryrun_lib.run_cell(arch, shape, mesh, mesh_label="test",
                                               overrides=ov))
            if (arch, shape) not in NO_PROBE:
                records.append(dryrun_lib.probe_cell(arch, shape, mesh, mesh_label="test",
                                                     overrides=ov))
    data_mesh = compat_make_mesh(*DATA_MESH)
    for arch in ARCHES:
        ov = overrides(get_smoke_config(arch))
        for shape in SHAPE_NAMES:
            records.append(dryrun_lib.run_cell(arch, shape, data_mesh, mesh_label="data",
                                               overrides=ov))
    for arch, shape in TP_CELLS:
        records.append(dryrun_lib.run_cell(arch, shape, mesh, mesh_label="test",
                                           overrides=overrides(get_smoke_config(arch))))
    for arch, shape in SP_CELLS:
        records.append(dryrun_lib.run_cell(arch, shape, mesh, mesh_label="test", sp=True,
                                           overrides=overrides(get_smoke_config(arch))))
    with open(sys.argv[1], "w") as f:
        json.dump(records, f)
    print(f"RESULT {sys.argv[1]}")
