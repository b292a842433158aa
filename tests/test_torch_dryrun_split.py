"""The dry-run's ``model``-axis collectives (``repro_torch.launch.roofline``
counting the port's own split on ``meta``) against the split's own counters
on CPU tensors and against GSPMD's partitioned HLO, on the CPU.

The dry-run side counts each cell of :data:`CELLS` at ``smoke()`` (zamba2
cut to two periods, :data:`CUT`) on a 2×2 ``meta`` mesh, one replica's
positions: a prefill, a decode against an ``S``-token cache, and a train
step of ``MB`` microbatches (one pass times ``MB``, and the clip).  The
CPU side runs the same entry points on drawn weights placed on a 2×2 CPU
mesh and reads :data:`repro_torch.core.mesh.collectives` and
:data:`~repro_torch.core.mesh.position_collectives`.  The reference side
compiles the same cells with JAX in a subprocess (4 fake host devices,
layers unrolled) and reads every ``all-reduce`` and ``all-gather`` over the
``model`` groups of its partitioned HLO.  Bounds, all exact:

* the dry-run's tally (count and result bytes of every ``all-reduce`` and
  ``all-gather``, by group size, at every position) equals the CPU run's
  at replica 0's positions; its per-chip ``all-reduce`` count equals the
  ``collectives`` counter's (train: a replica's ``MB`` passes and the
  clip, ``(counter − 1)/dp + 1``) and the design's count a layer kind
  (``PERF.md`` §3, :func:`layer_reduces`);
* every position of the CPU runs takes part in the same count and bytes;
* qwen3-0.6b's decode and train-pass bytes equal a hand reckoning from its
  ``smoke()`` shapes (:func:`test_qwen3_bytes_by_hand`);
* the collectives a chip takes part in, one by one (kind and result
  bytes), are GSPMD's but for the differences of the port's design, each
  named with its size from the shapes (:func:`design_differences`,
  :func:`train_differences`): prefill and decode for all ten archs (where
  GSPMD partitions a recurrent mixer its own way, the port's are among
  GSPMD's and the residual stream's reductions are GSPMD's), train for
  the six archs of attention and MLP layers (:data:`MEGATRON`);
* the layer- and sequence-extrapolated tally equals the direct count;
* a record's collective bytes are ``gradient_reduction``'s ring plus the
  per-chip ``model`` terms; a 1×1 mesh is charged none.

The dry-run's path imports neither ``jax`` nor ``repro``; only the
reference's subprocess does.
"""
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from fractions import Fraction

import numpy as np
import pytest
import torch

import repro_torch.configs as port_configs
from repro_torch.configs import ShapeCfg
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.mesh import make_mesh, psum_axes
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch import steps as port_steps
from repro_torch.launch.mesh import make_mesh2d
from repro_torch.models import model as M
from repro_torch.models.moe import capacity
from repro_torch.models.transformer import shared_config
from repro_torch.parallel import rules_for, use_sharding
from repro_torch.parallel import tensor as tensor_mod
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.parallel.tensor import ModelSplit, place_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = port_configs.ARCHS
B, S, MB = 4, 8, 2
DIMS = (2, 2)
DP = DIMS[0]                   # B / MB rows a microbatch divide over data
CUT = {"zamba2-2.7b": (("mamba", 2), ("mamba_shared", 1)) * 2}
CELLS = {"prefill": ShapeCfg("p", S, B, "prefill"),
         "decode": ShapeCfg("d", S, B, "decode"),
         "train": ShapeCfg("t", S, B, "train")}
#: the design's all-reduces a decode step, a layer of each kind
#: (``tests/test_torch_serve_mesh.py::DECODE_REDUCES``)
DECODE_REDUCES = {"attn": 5, "attn_moe": 5, "mla": 5, "mla_moe": 5,
                  "rwkv": 1, "mamba": 2, "mamba_shared": 7}


def layer_reduces(cfg, kind: str, m: int):
    """(forward, backward) all-reduces of one layer of ``kind`` in a pass
    on a ``model`` axis of ``m`` (``PERF.md`` §3;
    ``tests/test_torch_train_split.py::layer_reduces``)."""
    if kind in ("attn", "attn_moe"):
        heads = cfg.n_kv_heads % m == 0
        return 2, 2 + (2 if heads and cfg.qk_norm else 0)
    if kind in ("mla", "mla_moe"):
        return 2, 6
    if kind == "rwkv":
        return 1, 8
    if kind in ("mamba", "mamba_shared"):
        s = cfg.ssm
        cols = 2 * s.d_inner + 2 * s.d_state + s.n_heads
        f, b = 2, ((cols % m == 0) + 2 * (s.n_heads % m == 0)
                   + (s.d_inner % m == 0))
        if kind == "mamba_shared":
            f, b = f + 2, b + 2
        return f, b
    raise ValueError(kind)


def design_reduces(cfg, kind: str, m: int) -> int:
    """The design's all-reduces a chip: a prefill's forward (the
    embedding's sum, each layer's forward), a decode step's
    (:data:`DECODE_REDUCES`), or a train step's ``MB`` passes (the
    embedding's sum and the lm_head's input gradient, each layer's forward
    and backward, the forward again under ``remat``) and the clip's one."""
    if kind == "decode":
        return 1 + sum(DECODE_REDUCES[k] * c for k, c in cfg.segments)
    if kind == "prefill":
        return 1 + sum(layer_reduces(cfg, k, m)[0] * c
                       for k, c in cfg.segments)
    n = 2
    for k, c in cfg.segments:
        f, b = layer_reduces(cfg, k, m)
        n += c * (f + b + (f if cfg.remat != "none" else 0))
    return cfg.num_microbatches * n + 1


def _cfg(arch):
    kw = {"num_microbatches": MB}
    if arch in CUT:
        kw.update(segments=CUT[arch], n_layers=sum(c for _, c in CUT[arch]))
    return port_configs.get_config(arch).smoke(**kw)


def _flat(tally) -> dict:
    """:data:`~repro_torch.core.mesh.position_collectives` as the dry-run's
    flat tally."""
    return {(b, kind, n, f): v for b, t in tally.items()
            for (kind, n), (count, nbytes) in t.items()
            for f, v in (("n", count), ("bytes", nbytes))}


def _by_position(tally) -> dict:
    out = {}
    for (b, *key), v in tally.items():
        out.setdefault(b, {})[tuple(key)] = v
    return out


def _replica0(tally) -> dict:
    """The tally at replica 0's positions of the 2×2 mesh (``data`` 0)."""
    return {k: v for k, v in tally.items() if k[0] < DIMS[1]}


_META, _CPU = {}, {}


def _meta(arch, kind):
    """The dry-run's tally of ``CELLS[kind]`` on a 2×2 meta mesh."""
    key = (arch, kind)
    if key not in _META:
        mesh = make_mesh2d(*DIMS, device="meta")
        spec = specs.cell_specs(arch, CELLS[kind], mesh, cfg=_cfg(arch))
        _META[key] = roofline.cell_collectives(spec)
    return _META[key]


def _cpu(arch, kind):
    """(the ``all-reduce`` counter, the positions' tally) of the same cell
    run on drawn weights placed on a 2×2 CPU mesh."""
    key = (arch, kind)
    if key not in _CPU:
        cfg = _cfg(arch)
        rules = rules_for(cfg, make_mesh2d(*DIMS, device="cpu"))
        placed = place_params(M.init_params(cfg, seed=1, device="cpu"),
                              rules, cfg)
        shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
        tok = torch.from_numpy(np.random.default_rng(1).integers(
            1, cfg.vocab_size, shape).astype(np.int64))
        mesh_mod.reset_collectives()
        with use_sharding(rules):
            if kind == "train":
                port_steps.make_train_step(cfg)(
                    placed, port_steps.make_opt_state(placed),
                    {"tokens": tok, "labels": tok})
            elif kind == "prefill":
                with torch.no_grad():
                    port_steps.make_prefill_step(cfg)(placed, tok)
            else:
                cache = M.init_cache(cfg, B, S, device="cpu", rules=rules)
                with torch.no_grad():
                    port_steps.make_decode_step(cfg)(placed, cache,
                                                     tok[:, :1], S - 1)
        _CPU[key] = (mesh_mod.collectives["all-reduce"],
                     _flat(mesh_mod.position_collectives))
        mesh_mod.reset_collectives()
    return _CPU[key]


# ---------------------------------------------------------------------------
# the dry-run's tally against the split on CPU tensors and the design
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_tally_equals_the_split_on_cpu(arch, kind):
    """Prefill and decode: the meta tally (replica 0's pass) is the CPU
    run's at replica 0's positions, and it alone; its per-chip
    ``all-reduce`` count is the ``collectives`` counter's over one
    replica's groups and the design's."""
    meta = _meta(arch, kind)
    reduces, cpu = _cpu(arch, kind)
    assert meta == _replica0(cpu)
    chip = roofline.per_chip(meta)
    assert chip == roofline.per_chip(cpu)
    assert chip["all-reduce_n"] == reduces \
        == design_reduces(_cfg(arch), kind, DIMS[1])
    assert chip["all-reduce"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_tally_equals_the_step_on_cpu(arch):
    """A train step: the meta tally (replica 0's ``MB`` passes and the
    clip) is the CPU step's at replica 0's positions; per chip it counts
    ``(counter − 1)/dp + 1`` all-reduces, the design's."""
    meta = _meta(arch, "train")
    reduces, cpu = _cpu(arch, "train")
    mesh = make_mesh2d(*DIMS, device="meta")
    replica0 = {b for b in range(mesh.size) if mesh.coords(b)[0] == 0}
    assert _replica0(meta) == _replica0(cpu)
    chip = roofline.per_chip(meta)
    assert chip == roofline.per_chip(cpu)
    assert chip["all-reduce_n"] == (reduces - 1) // DP + 1 \
        == design_reduces(_cfg(arch), "train", DIMS[1])
    # the other replica's positions take part in the clip alone
    clip = {(b, "all-reduce", DIMS[1], "n"): 1 for b in range(mesh.size)
            if b not in replica0}
    assert {k: v for k, v in meta.items()
            if k[0] not in replica0 and k[3] == "n"} == clip


@pytest.mark.parametrize("arch", ARCHS)
def test_every_position_takes_part_alike(arch):
    """Every position of the CPU runs' tallies takes part in the same
    collectives with the same bytes: one replica's positions, which the
    dry-run counts, stand for every chip."""
    for tally in (_cpu(arch, kind)[1] for kind in CELLS):
        rows = _by_position(tally)
        assert sorted(rows) == list(range(4))
        assert all(r == rows[0] for r in rows.values())


def test_qwen3_bytes_by_hand():
    """qwen3-0.6b at ``smoke()`` (D 64, 4 heads and 2 kv heads of 16,
    vocab 256 tied, float32) on 2×2: a decode step of ``r = B/2`` rows a
    row block and a train pass of ``R = B/(MB·2)`` rows of ``S`` tokens,
    the ring bytes a position sends, from the shapes."""
    cfg, m = _cfg("qwen3-0.6b"), DIMS[1]
    d, h, kv, hd, v, f32 = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.vocab_size, 4)
    g = h // kv
    layers = cfg.n_layers

    def ar(part):                   # all-reduce over m: 2(m−1)/m
        return Fraction(2 * (m - 1) * part, m)

    def ag(result):                 # all-gather over m: (m−1)/m
        return Fraction((m - 1) * result, m)

    r = B // DP
    # decode: the embedding's sum (r, 1, D); a layer: q, k, v gathered by
    # columns, the softmax's max and denominator (r, kv, g, 1), the
    # context (r, kv, g, hd), wo's and the MLP's partials (r, 1, D); the
    # lm_head's vocab blocks gathered (r, 1, V)
    x = r * d * f32
    dec_ar = ar(x) + layers * (2 * ar(r * kv * g * f32)
                               + ar(r * kv * g * hd * f32) + 2 * ar(x))
    dec_ag = layers * (ag(r * h * hd * f32) + 2 * ag(r * kv * hd * f32)) \
        + ag(r * v * f32)
    chip = roofline.per_chip(_meta("qwen3-0.6b", "decode"))
    assert (chip["all-reduce"], chip["all-reduce_n"]) \
        == (dec_ar, 1 + 5 * layers)
    assert (chip["all-gather"], chip["all-gather_n"]) \
        == (dec_ag, 3 * layers + 1)

    # a train pass (kv heads split: each unit its own heads): forward the
    # embedding's sum, a layer the heads' and the MLP's partials (R, S, D)
    # and the keys and values gathered (R, S, kv, hd), the logits' vocab
    # gathered (R, S, V); backward the lm_head's input gradient, a layer
    # the gradients of x into the heads' and the MLP's units and of the
    # two qk-norm scales (hd,) that each head unit applies whole
    rr = B // MB // DP
    x = rr * S * d * f32
    pass_ar = ar(x) + layers * 2 * ar(x) \
        + ar(x) + layers * (2 * ar(x) + 2 * ar(hd * f32))
    pass_ag = layers * 2 * ag(rr * S * kv * hd * f32) + ag(rr * S * v * f32)
    chip = roofline.per_chip(_meta("qwen3-0.6b", "train"))
    assert (chip["all-reduce"], chip["all-reduce_n"]) \
        == (MB * pass_ar + ar(f32), MB * (2 + 6 * layers) + 1)
    assert (chip["all-gather"], chip["all-gather_n"]) \
        == (MB * pass_ag, MB * (2 * layers + 1))


# ---------------------------------------------------------------------------
# extrapolation and the record
# ---------------------------------------------------------------------------

def _deep(arch):
    """``smoke()`` cut to its first three segments, each two layers deep
    (three where there is one segment), with the published scan chunks:
    ``tests/test_torch_dryrun.py``'s cut."""
    cfg = port_configs.get_config(arch).smoke()
    depth = 3 if len(cfg.segments) == 1 else 2
    segs = tuple((k, depth) for k, _ in cfg.segments[:3])
    ssm = cfg.ssm and dataclasses.replace(cfg.ssm, chunk=64)
    return dataclasses.replace(cfg, segments=segs, ssm=ssm, rwkv_chunk=64,
                               n_layers=sum(c for _, c in segs),
                               num_microbatches=2)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_extrapolated_tally_equals_direct_count(arch):
    """Layer extrapolation (every cell kind) and sequence extrapolation
    (prefill above ``seq_direct``) give the direct tally's counts and bytes
    exactly, at every position: ``tests/test_torch_dryrun.py``'s cells."""
    cfg = _deep(arch)
    rules = rules_for(cfg, make_mesh2d(*DIMS, device="meta"))
    for shape in (ShapeCfg("t", 512, 4, "train"),
                  ShapeCfg("p", 4096, 2, "prefill"),
                  ShapeCfg("d", 2048, 3, "decode")):
        direct = roofline.count_collectives(cfg, shape, rules,
                                            seq_direct=shape.seq_len)
        got = roofline.collectives_extrapolated(cfg, shape, rules,
                                                seq_direct=2048)
        assert {k: v for k, v in got.items() if v} == direct, shape
        assert roofline.per_chip(direct)["all-reduce_n"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_record_charges_ring_plus_model_terms(kind):
    """A record's collective bytes are ``gradient_reduction``'s ring (train
    only) plus the per-chip ``model`` terms, its ``t_collective`` their
    time at the link rate; a 1×1 mesh is charged no ``model`` term."""
    cfg = _cfg("qwen3-0.6b")
    mesh = make_mesh2d(*DIMS, device="meta")
    rec = dryrun.run_cell("qwen3-0.6b", CELLS[kind], mesh=mesh, cfg=cfg,
                          verbose=False)
    spec = specs.cell_specs("qwen3-0.6b", CELLS[kind], mesh, cfg=cfg)
    ring = roofline.gradient_reduction(spec, mesh)
    model = roofline.per_chip(roofline.cell_collectives(spec))
    assert (ring["count"] > 0) == (kind == "train")
    total = ring["all-reduce"] + model["all-reduce"] + model["all-gather"]
    assert rec["collective_bytes_per_chip"] == pytest.approx(total,
                                                             rel=1e-15)
    assert rec["collective_bytes_per_chip"] > ring["all-reduce"]
    assert rec["t_collective"] == pytest.approx(total / roofline.ICI_BW,
                                                rel=1e-15)
    one = make_mesh2d(1, 1, device="meta")
    spec1 = specs.cell_specs("qwen3-0.6b", CELLS[kind], one, cfg=cfg)
    assert roofline.cell_collectives(spec1) == {}
    rec1 = dryrun.run_cell("qwen3-0.6b", CELLS[kind], mesh=one, cfg=cfg,
                           verbose=False)
    assert rec1["collective_bytes_per_chip"] == 0


# ---------------------------------------------------------------------------
# the tally's own contracts
# ---------------------------------------------------------------------------

def test_tally_uses_the_ring_convention():
    """``psum_axes`` over groups of 4 tallies each position its (nested)
    part, which :func:`per_chip` charges ``2·3/4`` of, and counts one
    ``all-reduce`` as before; a group of one position moves nothing; a
    gather of an unbound split is tallied at its row block's positions
    only, its result charged ``1/2`` on 2×2."""
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    part = [torch.ones(3), [torch.ones(2, dtype=torch.float64)]]
    mesh_mod.reset_collectives()
    psum_axes([part] * 4, mesh, "model")
    psum_axes([torch.ones(5)] * 4, mesh, "data")      # groups of one
    assert mesh_mod.collectives["all-reduce"] == 2
    want = {("all-reduce", 4): [1, 3 * 4 + 2 * 8]}
    assert mesh_mod.position_collectives == {b: want for b in range(4)}
    chip = roofline.per_chip(_flat(mesh_mod.position_collectives))
    assert (chip["all-reduce"], chip["all-reduce_n"], chip["count"]) \
        == (2 * 3 * (3 * 4 + 2 * 8) / 4, 1, 1)

    split = ModelSplit(ShardingRules(make_mesh(DIMS, ("data", "model"),
                                               device="cpu")), 4)
    mesh_mod.reset_collectives()
    for r in range(split.dp):
        split.gather([torch.ones(2, 3), torch.ones(2, 3)], -1, r)
    assert mesh_mod.collectives["all-reduce"] == 0
    want = {("all-gather", 2): [1, 2 * 6 * 4]}
    assert mesh_mod.position_collectives == {b: want for b in range(4)}
    chip = roofline.per_chip(_flat(mesh_mod.position_collectives))
    assert (chip["all-gather"], chip["all-gather_n"]) == (2 * 6 * 4 / 2, 1)
    bound = split.bind(1)
    mesh_mod.reset_collectives()
    bound.gather([torch.ones(2, 3), torch.ones(2, 3)], -1, 0)
    bound.psum([[torch.ones(2), torch.ones(2)]])
    assert set(mesh_mod.position_collectives) == {2, 3}
    mesh_mod.reset_collectives()
    assert mesh_mod.position_collectives == {}


def test_counting_leaves_the_counters_and_imports_no_jax():
    """Counting a cell leaves the caller's counters as they were, and the
    dry-run's count imports neither ``jax`` nor ``repro``."""
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    mesh_mod.reset_collectives()
    psum_axes([torch.ones(1)] * 4, mesh, "model")
    before = (dict(mesh_mod.collectives),
              {b: {k: list(v) for k, v in t.items()}
               for b, t in mesh_mod.position_collectives.items()})
    cfg = _cfg("qwen3-0.6b")
    rules = rules_for(cfg, make_mesh2d(1, 4, device="meta"))
    assert roofline.count_collectives(cfg, CELLS["decode"], rules)
    assert (mesh_mod.collectives, mesh_mod.position_collectives) == before
    mesh_mod.reset_collectives()
    code = ("import sys\n"
            "from repro_torch.configs import get_config, ShapeCfg\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.launch.mesh import make_mesh2d\n"
            "rec = dryrun.run_cell('qwen3-0.6b', ShapeCfg('d', 8, 4, "
            "'decode'), mesh=make_mesh2d(2, 2, device='meta'), "
            "cfg=get_config('qwen3-0.6b').smoke(), verbose=False)\n"
            "assert rec['collective_bytes_per_chip'] > 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# against GSPMD: the reference's partitioned HLO of the same cells
# ---------------------------------------------------------------------------

#: the reference's steps of :data:`GSPMD_CELLS` at the cells' size
#: (``_cfg``'s config, layers unrolled) compiled on a 2×2 mesh of 4 fake
#: host devices; printed: each ``all-reduce`` / ``all-gather`` over the
#: ``model`` groups as ``[kind, result bytes, [each operand's bytes]]``
#: (the bytes of ``repro.launch.roofline.collective_bytes``; XLA combines
#: independent reductions into one of several operands)
GSPMD_SCRIPT = r"""
import dataclasses, json, re, sys
import numpy as np
import jax
from repro.configs import SHAPES, get_config
from repro.configs.base import ShapeCfg
from repro.launch.mesh import make_mesh2d
from repro.launch.roofline import _shape_bytes
from repro.launch.specs import cell_specs
from repro.parallel.sharding import use_sharding

cells, b, s, mb, cut = json.loads(sys.argv[1])
OP = re.compile(r"%?[\w.\-]+ = (.+?) (all-gather|all-reduce)(-start)?\(")
GROUPS = re.compile(r"replica_groups=(\{[{}0-9,]*\}|\[[0-9,]+\]<=\[[0-9,]+\]"
                    r"(?:T\([0-9,]+\))?)")

def groups(text):
    if text.startswith("{"):
        return [[int(i) for i in g.split(",")]
                for g in re.findall(r"\{([0-9,]+)\}", text)] or None
    shape, dims, perm = re.match(
        r"\[([0-9,]+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?", text).groups()
    ids = np.arange(int(np.prod([int(d) for d in dims.split(",")])))
    ids = ids.reshape([int(d) for d in dims.split(",")])
    if perm:
        ids = ids.transpose([int(p) for p in perm.split(",")])
    return ids.reshape([int(d) for d in shape.split(",")]).tolist()

mesh = make_mesh2d(2, 2)
ids = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
model = sorted(sorted(g) for g in np.moveaxis(
    ids, mesh.axis_names.index("model"), -1).reshape(-1, mesh.shape["model"])
    .tolist())
out = {}
for arch, kind in cells:
    kw = {"num_microbatches": mb}
    if arch in cut:
        seg = tuple(tuple(x) for x in cut[arch])
        kw.update(segments=seg, n_layers=sum(c for _, c in seg))
    cfg = dataclasses.replace(get_config(arch).smoke(**kw), scan_layers=False)
    SHAPES[kind] = ShapeCfg(kind, s, b, kind)
    spec = cell_specs(arch, kind, mesh, cfg=cfg)
    jitted = jax.jit(spec["fn"], in_shardings=spec["in_shardings"],
                     out_shardings=spec.get("out_shardings"),
                     donate_argnums=spec["donate_argnums"])
    with use_sharding(spec["rules"]):
        hlo = jitted.lower(*spec["args"]).compile().as_text()
    ops = []
    for line in hlo.splitlines():
        m = OP.match(line.strip())
        g = m and GROUPS.search(line)
        if g and sorted(sorted(x) for x in groups(g.group(1)) or []) \
                == model:
            ops.append([m.group(2), _shape_bytes(m.group(1)),
                        [_shape_bytes(t) for t in re.findall(
                            r"[a-z]+[0-9]+\[[0-9,]*\]", m.group(1))]])
    out[arch + "/" + kind] = ops
json.dump(out, sys.stdout)
"""

F32 = 4                        # ``smoke()`` computes in float32
#: the archs whose every layer splits as GSPMD partitions it, up to the
#: named differences of :func:`design_differences`, in train too
MEGATRON = ["glm4-9b", "qwen3-0.6b", "starcoder2-3b", "musicgen-medium",
            "chameleon-34b", "mixtral-8x7b"]
GSPMD_CELLS = [[a, k] for a in ARCHS for k in ("prefill", "decode")] \
    + [[a, "train"] for a in MEGATRON]


@pytest.fixture(scope="module", autouse=True)
def _gspmd_run():
    """The reference's compiles, started with the file's first test so that
    they run beside the port's counts."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    arg = json.dumps([GSPMD_CELLS, B, S, MB, CUT])
    proc = subprocess.Popen([sys.executable, "-c", GSPMD_SCRIPT, arg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def gspmd(_gspmd_run):
    out, err = _gspmd_run.communicate(timeout=600)
    assert _gspmd_run.returncode == 0, err[-4000:]
    return json.loads(out)


def _port_events(arch, kind, monkeypatch):
    """The dry-run's step of ``CELLS[kind]`` on the 2×2 meta mesh with
    every collective that position 0 takes part in logged as ``(kind,
    result bytes)`` (train: one pass times ``MB``, and the clip); the
    log's sums are the dry-run's tally's."""
    want = _meta(arch, kind)
    events = Counter()
    record = mesh_mod.record_collective

    def log(coll, mesh, members, nbytes):
        if len(members) > 1 and 0 in [mesh.positions[b] for b in members]:
            events[(coll, nbytes)] += 1
        record(coll, mesh, members, nbytes)

    monkeypatch.setattr(mesh_mod, "record_collective", log)
    monkeypatch.setattr(tensor_mod, "record_collective", log)
    cfg = _cfg(arch)
    rules = rules_for(cfg, make_mesh2d(*DIMS, device="meta"))
    if kind == "train":
        roofline.collectives_pass(cfg, kind, B // MB, S, rules)
        events = Counter({k: MB * n for k, n in events.items()})
        placed = place_params(M.init_params(cfg, device="meta"), rules, cfg)
        roofline._tally(lambda: port_steps.clip_placed(placed, 1.0))
    else:
        roofline.collectives_pass(cfg, kind, B, S, rules)
    for coll in roofline._MODEL_KINDS:
        mine = [(n, b) for (c, b), n in events.items() if c == coll]
        assert (sum(n for n, _ in mine), sum(n * b for n, b in mine)) == (
            want.get((0, coll, DIMS[1], "n"), 0),
            want.get((0, coll, DIMS[1], "bytes"), 0))
    return events


def design_differences(arch, kind):
    """What the port's split makes at position 0 that GSPMD's does not
    (``port``) and the reverse (``ref``), by name, as ``{name: (kind,
    result bytes, count)}``, at the cells' size on 2×2 (``rows`` a row
    block, ``s`` tokens a row).  ``ref`` is None where GSPMD partitions a
    layer kind its own way (the recurrent mixers: it gathers weights and
    reduces LoRA and chunk partials that the port's split keeps whole):
    there it is not listed, and only the reductions of the residual
    stream are held to it."""
    cfg = _cfg(arch)
    rows, s = B // DP, S if kind == "prefill" else 1
    layers = Counter()
    for k, c in cfg.segments:
        layers[k] += c
    port = {"the lm_head's vocab blocks gathered (last token)": (
        "all-gather", rows * cfg.vocab_size * cfg.n_codebooks * F32, 1)}
    ref = {}
    attn = layers["attn"] + layers["attn_moe"]
    if kind == "prefill" and attn:
        port["keys and values gathered from the kv-head units"] = (
            "all-gather", rows * S * cfg.n_kv_heads * cfg.head_dim * F32,
            2 * attn)
    if kind == "prefill" and layers["mamba_shared"]:
        sc = shared_config(cfg)
        port["the shared block's keys and values gathered"] = (
            "all-gather", rows * S * sc.n_kv_heads * sc.head_dim * F32,
            2 * layers["mamba_shared"])
    mla = layers["mla"] + layers["mla_moe"]
    if kind == "decode" and mla:
        h, dn, dr, dv, rkv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                              cfg.v_head_dim, cfg.kv_lora_rank)
        port.update({
            "the query's up-projection gathered": (
                "all-gather", rows * h * (dn + dr) * F32, mla),
            "wkv_b gathered whole": ("all-gather", rkv * h * (dn + dv) * F32,
                                     mla),
            "the softmax's max and denominator over the sequence blocks": (
                "all-reduce", rows * h * F32, 2 * mla),
            "the context summed over the sequence blocks": (
                "all-reduce", rows * h * dv * F32, mla)})
        ref.update({
            "the latent cache gathered over the sequence": (
                "all-gather", rows * S * rkv * F32, mla),
            "the query's rope part gathered over heads": (
                "all-gather", rows * h * dr * F32, mla)})
    if layers["mla_moe"]:
        m, n = cfg.moe, layers["mla_moe"]
        port.update({
            "the expert slots' outputs gathered over experts": (
                "all-gather",
                rows * m.n_experts * capacity(s, m) * cfg.d_model * F32, n),
            "the shared experts' sum alone": (
                "all-reduce", rows * s * cfg.d_model * F32, n)})
        ref["the routed outputs summed with the shared experts'"] = (
            "all-reduce", rows * s * (1 + m.top_k) * cfg.d_model * F32, n)
    ssm = layers["mamba"] + layers["mamba_shared"]
    if ssm:
        c = cfg.ssm
        port.update({
            "in_proj's column blocks gathered": (
                "all-gather",
                rows * s * (2 * c.d_inner + 2 * c.d_state + c.n_heads) * F32,
                ssm),
            "the conv's channel blocks gathered": (
                "all-gather", rows * s * (c.d_inner + 2 * c.d_state) * F32,
                ssm)})
    if ssm or layers["rwkv"]:
        ref = None
    return port, ref


def _counter(named) -> Counter:
    out = Counter()
    for coll, nbytes, n in named.values():
        out[(coll, nbytes)] += n
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_collectives_equal_gspmd_but_for_the_design(
        gspmd, arch, kind, monkeypatch):
    """The collectives a chip takes part in, one by one (kind and result
    bytes), are GSPMD's in the reference's partitioned HLO but for the
    differences of the port's design that :func:`design_differences`
    names; where GSPMD partitions a recurrent mixer its own way, every
    collective of the port's but the named ones is one of GSPMD's, and the
    reductions of the residual stream (parts of ``rows × s × d_model`` or,
    in zamba2's shared block, ``2·d_model``) are GSPMD's."""
    port_only, ref_only = (None if d is None else _counter(d)
                           for d in design_differences(arch, kind))
    port = _port_events(arch, kind, monkeypatch)
    ref = Counter((c, b) for c, b, _ in gspmd[f"{arch}/{kind}"])
    assert port_only <= port, port_only - port
    if ref_only is not None:
        assert ref_only <= ref, ref_only - ref
        assert port - port_only == ref - ref_only
        return
    assert port - port_only <= ref, (port - port_only) - ref
    cfg = _cfg(arch)
    s = S if kind == "prefill" else 1
    resid = {("all-reduce", B // DP * s * w * cfg.d_model * F32)
             for w in (1, 2)}
    assert {k: n for k, n in port.items() if k in resid} \
        == {k: n for k, n in ref.items() if k in resid}


def train_differences(arch):
    """:func:`design_differences` of a train step (``MB`` passes of
    ``rows`` rows a replica, each with its backward) for the archs of
    :data:`MEGATRON`: the port's gathers for the cache layout and the
    loss, GSPMD's loss over the vocab blocks, its embedding gradient's
    scatter of the token ids, and its backward reducing each
    column-parallel product's input gradient (the attention's q, k and v;
    a gated MLP's gate and up; mixtral's gate and up slot buffers) where
    the port's :meth:`~repro_torch.parallel.tensor.ModelSplit.fan` sums
    the units' gradients first and reduces once."""
    cfg = _cfg(arch)
    rows, k = B // MB // DP, cfg.n_codebooks
    layers = Counter()
    for kind, c in cfg.segments:
        layers[kind] += c
    attn = layers["attn"] + layers["attn_moe"]
    x = rows * S * cfg.d_model * F32
    port = {
        "keys and values gathered from the kv-head units": (
            "all-gather", rows * S * cfg.n_kv_heads * cfg.head_dim * F32,
            2 * attn * MB),
        "the logits' vocab blocks gathered for the loss": (
            "all-gather", rows * S * k * cfg.vocab_size * F32, MB)}
    ref = {
        "the loss's softmax over the vocab blocks (max, denominator, "
        "the label's log-probability, the gradient's sum)": (
            "all-reduce", rows * S * k * F32, 4 * MB),
        "the embedding gradient's token ids gathered": (
            "all-gather", B // MB * S * 4, k * MB),
        "each column-parallel product's input gradient reduced": (
            "all-reduce", x, (2 * attn + layers["attn"] * cfg.gated_mlp)
            * MB)}
    if k > 1:
        port["the codebooks' lookups summed in one reduction"] = (
            "all-reduce", k * x, MB)
        ref["one lookup sum a codebook"] = ("all-reduce", x, k * MB)
    if layers["attn_moe"]:
        m = cfg.moe
        ref["the expert slots' gate and up gradients reduced apart"] = (
            "all-reduce",
            rows * m.n_experts * capacity(S, m) * cfg.d_model * F32,
            layers["attn_moe"] * MB)
    return port, ref


@pytest.mark.parametrize("arch", MEGATRON)
def test_train_collectives_equal_gspmd_but_for_the_design(
        gspmd, arch, monkeypatch):
    """A train step's collectives at a chip, one by one, are GSPMD's (each
    operand of a reduction that XLA combined counted as one) but for
    :func:`train_differences`'s, and but for the scalars: the port's one
    is the clip's all-reduce of its summed squares (GSPMD reduces partial
    sums of squares as its fusions group the leaves)."""
    port_only, ref_only = map(_counter, train_differences(arch))
    port = _port_events(arch, "train", monkeypatch)
    ref = Counter((c, e) for c, _, elems in gspmd[f"{arch}/train"]
                  for e in elems)
    scalar = ("all-reduce", F32)
    assert port[scalar] == 1 and ref[scalar] >= 1
    del port[scalar], ref[scalar]
    assert port_only <= port, port_only - port
    assert ref_only <= ref, ref_only - ref
    assert port - port_only == ref - ref_only
