"""The port's data pipeline and optimizer (``repro_torch.{data,optim}``)
against the JAX reference (``repro.{data,optim}``) on the CPU.

* ``tests/test_substrate.py``'s data, optimizer and compression tests run
  on the port as written there;
* ``TokenDataset`` batches and ``pack_documents`` rows equal the
  reference's bit for bit (the same NumPy code and seeding);
* ``cosine_schedule``, ``clip_by_global_norm``, three ``adamw_update``
  steps, ``quantize_int8`` / ``dequantize_int8`` and
  ``compress_error_feedback`` on the same float32 inputs as the reference
  (jitted) agree within 2 float32 ulps of each value: both compute in
  float32, but XLA's CPU backend contracts ``a·b + c`` into one FMA
  (one rounding fewer), and its ``cos``, ``pow`` and reductions may round
  or associate otherwise.  The int8 payloads are equal, and so are the
  scales within 2 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as ref_data
import repro.optim as ref_optim
import repro_torch.data as port_data
import repro_torch.optim as port_optim
from repro_torch.data import TokenDataset, pack_documents, shard_batch
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_error_feedback, cosine_schedule,
                               dequantize_int8, quantize_int8)
from repro_torch.optim.adamw import AdamWState

ULPS = 2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ulps_close(got, want, ulps=ULPS, what=""):
    """|got − want| ≤ ulps · spacing(|want|), elementwise, in float32."""
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want)).astype(np.float32)
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} beyond {ulps} ulps, max "
        f"{float(np.abs(got.astype(np.float64) - want).max())}")


# -- tests/test_substrate.py on the port --------------------------------------

def test_dataset_deterministic_and_restartable():
    ds = TokenDataset(1000, 32, 4, seed=7)
    b1 = [ds.next_batch() for _ in range(3)]
    state = ds.state()
    b_next = ds.next_batch()
    ds2 = TokenDataset(1000, 32, 4, seed=7)
    ds2.restore(state)
    b_replay = ds2.next_batch()
    np.testing.assert_array_equal(b_next["tokens"], b_replay["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1[0]["tokens"][:, 1:],
                                  b1[0]["labels"][:, :-1])


def test_packing():
    docs = [np.arange(1, 10, dtype=np.int32)] * 5
    rows = list(pack_documents(iter(docs), seq_len=16))
    assert all(r.shape == (17,) for r in rows)
    assert sum(r.size for r in rows) <= 5 * 10 + 17


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}           # d/dw ||w||²
        params, opt = adamw_update(params, grads, opt, lr=0.05,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_clip_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 20.0)
    np.testing.assert_allclose(
        float(torch.linalg.vector_norm(clipped["a"])), 1.0, rtol=1e-5)


def test_cosine_schedule_shape():
    assert float(cosine_schedule(0, peak_lr=1.0, warmup=10, total=100)) == 0.0
    assert float(cosine_schedule(10, peak_lr=1.0, warmup=10,
                                 total=100)) == pytest.approx(1.0)
    end = float(cosine_schedule(100, peak_lr=1.0, warmup=10, total=100))
    assert end == pytest.approx(0.1, abs=1e-3)


def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = quantize_int8(x)
    err = np.abs(dequantize_int8(q, s).numpy() - x.numpy())
    assert err.max() <= float(s) * 0.5 + 1e-7


def test_error_feedback_unbiased_over_steps():
    """With constant grads, error feedback recovers the true mean exactly."""
    g = {"w": torch.tensor([0.013, -0.031, 0.004], dtype=torch.float32)}
    resid = {"w": torch.zeros_like(g["w"])}
    total = torch.zeros(3)
    n = 64
    for _ in range(n):
        deq, resid = compress_error_feedback(g, resid)
        total = total + deq["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               atol=1e-3)


# -- bit for bit / within 2 ulps of the reference ------------------------------

def test_public_names_equal_reference():
    assert set(port_data.__all__) == set(ref_data.__all__)
    assert set(port_optim.__all__) == set(ref_optim.__all__)


@pytest.mark.parametrize("seed,batch,seq,codebooks", [
    (0, 8, 64, 1), (7, 4, 33, 1), (3, 2, 16, 4)])
def test_dataset_equals_reference(seed, batch, seq, codebooks):
    """Five batches, a restore to batch 2 and the replay: bit for bit."""
    mine = TokenDataset(1000, seq, batch, seed=seed, n_codebooks=codebooks)
    ref = ref_data.TokenDataset(1000, seq, batch, seed=seed,
                                n_codebooks=codebooks)
    for _ in range(5):
        a, b = mine.next_batch(), ref.next_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state() == ref.state()
    mine.restore({"seed": seed, "step": 2})
    ref.restore({"seed": seed, "step": 2})
    np.testing.assert_array_equal(mine.next_batch()["tokens"],
                                  ref.next_batch()["tokens"])


def test_packing_equals_reference():
    """Rows packed from the seeded document stream: bit for bit."""
    from repro.data.pipeline import _doc_stream as ref_stream
    from repro_torch.data.pipeline import _doc_stream

    def rows(stream, pack):
        it = pack(stream(5, 500, mean_len=40), seq_len=64)
        return [next(it) for _ in range(30)]

    for a, b in zip(rows(_doc_stream, pack_documents),
                    rows(ref_stream, ref_data.pack_documents)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_shard_batch_copies_int64_to_the_device():
    b = TokenDataset(100, 8, 2, seed=1).next_batch()
    out = shard_batch(b, "cpu")
    for k in ("tokens", "labels"):
        assert out[k].dtype == torch.int64 and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), b[k])


@pytest.mark.parametrize("warmup,total", [(10, 100), (5, 24), (100, 10000),
                                          (0, 7)])
def test_cosine_schedule_matches_reference(warmup, total):
    """Every step to ``total + 2`` against the reference evaluated op by op
    (``jax.disable_jit``, no FMA contraction): 2 ulps of the rate, plus one
    ulp of ``cos`` carried through ``peak·0.45·(1 + cos)`` — XLA's ``cos``
    and the C library's differ by an ulp at a few arguments, and near the
    end of the decay ``1 + cos`` cancels, so that ulp is many of the
    rate's."""
    peak = 1e-3
    steps = list(range(0, total + 3))
    with jax.disable_jit():
        want = np.asarray(ref_optim.cosine_schedule(
            jnp.asarray(steps, jnp.int32), peak_lr=peak, warmup=warmup,
            total=total))
    got = cosine_schedule(torch.tensor(steps, dtype=torch.int32),
                          peak_lr=peak, warmup=warmup, total=total)
    assert got.dtype == torch.float32
    tol = (ULPS * np.spacing(np.abs(want)).astype(np.float64)
           + peak * 0.45 * float(np.spacing(np.float32(1.0))))
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= tol).all(), float((err / tol).max())
    # the warm-up is exact: no cos in it
    np.testing.assert_array_equal(got.numpy()[:warmup], want[:warmup])


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.normal(size=(5, 7))).astype(np.float32),
            "nest": {"b": (scale * rng.normal(size=(13,))).astype(np.float32),
                     "c": [(scale * rng.normal(size=(3, 2))).astype(
                         np.float32)]}}


def _to_torch(tree):
    return port_optim.tree.tree_map(_t, tree)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_matches_reference(max_norm):
    """The norm within 2 ulps (the two libraries add the squares in other
    orders); each clipped gradient within 2 ulps of itself plus the norm's
    relative difference, which the scale ``max_norm / ‖g‖`` carries into
    every element when it clips."""
    g = _tree(1, scale=3.0)
    want, wnorm = jax.jit(lambda t: ref_optim.clip_by_global_norm(
        t, max_norm))(jax.tree.map(jnp.asarray, g))
    got, norm = clip_by_global_norm(_to_torch(g), max_norm)
    _ulps_close(norm, np.asarray(wnorm), what="norm")
    rel = abs(float(norm) - float(wnorm)) / float(wnorm)
    for a, b in zip(port_optim.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        tol = ULPS * np.spacing(np.abs(b)).astype(np.float64) + rel * np.abs(b)
        assert (np.abs(a.numpy().astype(np.float64) - b) <= tol).all()
        if max_norm > float(wnorm):        # no clip: the gradients as given
            np.testing.assert_array_equal(a.numpy(), b)


def test_adamw_three_steps_match_reference():
    """Three AdamW steps on the same params and grads (a float32 lr tensor
    from the schedule, as the train step passes it)."""
    p0, grads = _tree(2), [_tree(10 + i, scale=0.1) for i in range(3)]
    upd = jax.jit(lambda p, g, s, lr: ref_optim.adamw_update(p, g, s, lr))
    rp = jax.tree.map(jnp.asarray, p0)
    rs = ref_optim.adamw_init(rp)
    pp = _to_torch(p0)
    ps = adamw_init(pp)
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1) / 3
        rp, rs = upd(rp, jax.tree.map(jnp.asarray, g), rs, jnp.float32(lr))
        pp, ps = adamw_update(pp, _to_torch(g), ps,
                              torch.tensor(lr, dtype=torch.float32))
    assert isinstance(ps, AdamWState) and int(ps.step) == int(rs.step) == 3
    assert ps.step.dtype == torch.int32
    for mine, ref in ((pp, rp), (ps.m, rs.m), (ps.v, rs.v)):
        for a, b in zip(port_optim.tree.leaves(mine), jax.tree.leaves(ref)):
            assert a.dtype == torch.float32
            _ulps_close(a, np.asarray(b), what="adamw")


def test_adamw_bfloat16_params_keep_their_dtype():
    """bfloat16 parameters with float32 moments: the update computes in
    float32 and casts back, as the reference's (same bits after the cast
    for all but ulp-ties of the float32 value)."""
    p = {"w": np.random.default_rng(3).normal(size=(64,)).astype(np.float32)}
    g = {"w": np.random.default_rng(4).normal(size=(64,)).astype(np.float32)}
    rp = {"w": jnp.asarray(p["w"], jnp.bfloat16)}
    rp, rs = jax.jit(ref_optim.adamw_update)(
        rp, {"w": jnp.asarray(g["w"], jnp.bfloat16)},
        ref_optim.adamw_init(rp), jnp.float32(1e-2))
    pp = {"w": torch.from_numpy(p["w"]).bfloat16()}
    pp, ps = adamw_update(pp, {"w": torch.from_numpy(g["w"]).bfloat16()},
                          adamw_init(pp), torch.tensor(1e-2))
    assert pp["w"].dtype == torch.bfloat16 and ps.m["w"].dtype == torch.float32
    want = np.asarray(rp["w"].astype(jnp.float32))
    got = pp["w"].float().numpy()
    # one bfloat16 ulp where the float32 value sits on a rounding tie
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    _ulps_close(ps.v["w"], np.asarray(rs.v["w"]), what="v")


@pytest.mark.parametrize("scale", [1.0, 1e-9, 0.0])
def test_quantize_matches_reference(scale):
    x = (scale * np.random.default_rng(5).normal(size=(1000,))).astype(
        np.float32)
    x[:3] = [0.5 * scale, -0.5 * scale, 2.5 * scale]   # near halves
    rq, rs = jax.jit(ref_optim.quantize_int8)(jnp.asarray(x))
    q, s = quantize_int8(_t(x))
    assert q.dtype == torch.int8
    _ulps_close(s, np.asarray(rs), what="scale")
    if float(s) == float(rs):
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    _ulps_close(dequantize_int8(q, s), np.asarray(
        ref_optim.dequantize_int8(rq, rs)), what="dequantized")


def test_round_half_to_even_as_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0],
                 np.float32)
    np.testing.assert_array_equal(torch.round(_t(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


def test_error_feedback_matches_reference_over_steps():
    """Four steps of compression with the residual carried, against the
    reference evaluated op by op (``jax.disable_jit``: jitted, XLA fuses
    ``gf − q·s`` into one FMA and the residual moves by half an ulp of the
    dequantized value): the dequantized grads and the residual within 2
    ulps of the dequantized values (the residual is the difference of two
    values of that size), the int8 payloads equal."""
    rr = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), _tree(0))
    pr = port_optim.tree.tree_map(torch.zeros_like, _to_torch(_tree(0)))
    for i in range(4):
        g = _tree(20 + i, scale=0.01)
        with jax.disable_jit():
            rd, rr = ref_optim.compress_error_feedback(
                jax.tree.map(jnp.asarray, g), rr)
        pd, pr = compress_error_feedback(_to_torch(g), pr)
        for a, b, c, d in zip(port_optim.tree.leaves(pd), jax.tree.leaves(rd),
                              port_optim.tree.leaves(pr),
                              jax.tree.leaves(rr)):
            b, d = np.asarray(b), np.asarray(d)
            ulp = float(np.spacing(np.float32(np.abs(b).max())))
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ULPS * ulp)
            np.testing.assert_allclose(c.numpy(), d, rtol=0, atol=ULPS * ulp)


# -- trees holding NamedTuples ------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_tree_map_rebuilds_namedtuples(arch):
    """``tree_map`` over the compressed optimizer state (an ``AdamWState``
    in a dict) and over the decode cache of each kind (``KVCache``,
    ``MLACache``, ``RWKVState``, ``SSMState`` and zamba2's shared-block
    dict) keeps every container's type and every leaf's place."""
    import repro_torch.configs as port_configs
    from repro_torch.launch.steps import make_opt_state
    from repro_torch.models import model as M

    cfg = port_configs.get_config(arch).smoke()
    params = M.init_params(cfg, seed=0, device="cpu")
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    for tree in (make_opt_state(params, compress=True), cache):
        got = port_optim.tree.tree_map(lambda t: t + 1, tree)

        def same_shape(a, b):
            assert type(a) is type(b)
            if isinstance(a, dict):
                assert list(a) == list(b)
                for k in a:
                    same_shape(a[k], b[k])
            elif isinstance(a, (list, tuple)):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    same_shape(x, y)
            else:
                assert torch.equal(a, b - 1)

        same_shape(tree, got)
    kinds = {type(c).__name__ for seg in cache for c in seg}
    want = {"qwen3-0.6b": {"KVCache"}, "deepseek-v2-236b": {"MLACache"},
            "rwkv6-7b": {"RWKVState"}, "zamba2-2.7b": {"SSMState", "dict"}}
    assert kinds == want[arch]


def test_unflatten_keeps_no_reference_to_its_values():
    """A rebuilt tree is the only holder of its leaves: once it is dropped
    they are freed at once, not when Python's cycle collector next runs
    (the train step's gradients, a parameter set each pass, went through
    ``unflatten`` and lingered that way)."""
    import gc
    import weakref

    leaf = torch.zeros(4)
    ref = weakref.ref(leaf)
    was = gc.isenabled()
    gc.disable()
    try:
        tree = port_optim.tree.unflatten(
            {"a": [0, (1,)], "s": AdamWState(0, 1, 2)}, [leaf] * 6)
        del leaf, tree
        assert ref() is None
    finally:
        if was:
            gc.enable()
