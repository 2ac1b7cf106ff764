"""The port's LM layers (norms, RoPE, attention core, MoE, capacity
calibration) against the JAX reference, on the CPU.

Inputs come from numpy seeds; parameters are the reference's, carried to
the port as numpy. Tolerance: rtol 1e-4 / atol 1e-5 on f32 values (both
sides sum in f32, in other orders), atol taken relative to the largest
|value| of the reference's output. Integers — capacities, routing,
overflow fractions — match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, convert, layers, moe  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def test_norms():
    x, w, bias = rand(0, 3, 5, 48, scale=3.0), rand(1, 48), rand(2, 48)
    close(layers.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
          rlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    close(layers.layer_norm(torch.tensor(x), torch.tensor(w),
                            torch.tensor(bias)),
          rlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(bias)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_frequencies_are_the_reference_f32(theta):
    got = layers.rope_frequencies(128, theta).astype(np.float32)
    want = np.asarray(jnp.asarray(rlayers.rope_frequencies(128, theta),
                                  jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mrope", [False, True])
def test_apply_rope(mrope):
    b, l, h, dh = 2, 40, 3, 32
    x = rand(3, b, l, h, dh)
    rng = np.random.default_rng(4)
    if mrope:   # three distinct position streams, sections over dh / 2
        pos, sections = rng.integers(0, 5000, (3, b, l)), (4, 6, 6)
    else:
        pos, sections = rng.integers(0, 5000, (b, l)), ()
    got = layers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6, sections)
    want = rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                              1e6, sections)
    close(got, want)


# ---------------------------------------------------------------------------
# Attention core: the direct path up to 1024 positions, chunked past it
# ---------------------------------------------------------------------------

ATTN_CASES = [
    ("direct", 1024, {}),
    ("chunked", 1025, {}),
    ("direct-window-softcap", 1024, dict(window=64, softcap=30.0)),
    ("chunked-window-softcap", 1025, dict(window=300, softcap=20.0)),
    ("chunked-kv_len", 1025, dict(causal=False, kv_len=[700, 1025])),
    ("direct-kv_len-q_start", 512, dict(q_start=100, kv_len=[300, 512])),
]


@pytest.mark.parametrize("name,length,kw", ATTN_CASES,
                         ids=[c[0] for c in ATTN_CASES])
def test_attention_core(name, length, kw):
    b, hq, hkv, dh = 2, 4, 2, 16
    q, k, v = (rand(s, b, length, h, dh)
               for s, h in ((5, hq), (6, hkv), (7, hkv)))
    pkw = dict(kw)
    rkw = dict(kw)
    if "kv_len" in kw:
        pkw["kv_len"] = torch.tensor(kw["kv_len"])
        rkw["kv_len"] = jnp.asarray(kw["kv_len"], jnp.int32)
    got = attention.attention_core(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), **pkw)
    want = rattn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **rkw)
    close(got, want)


def test_gqa_head_grouping():
    """Query head h reads KV head h // (Hq / Hkv): one KV head of values
    set apart shows up only in its group's query heads."""
    b, l, hq, hkv, dh = 1, 8, 4, 2, 8
    q, k = torch.tensor(rand(8, b, l, hq, dh)), torch.tensor(rand(9, b, l,
                                                                  hkv, dh))
    v = torch.zeros(b, l, hkv, dh)
    v[:, :, 1] = 1.0
    out = attention.attention_core(q, k, v)
    assert torch.all(out[:, :, :2] == 0) and torch.allclose(
        out[:, :, 2:], torch.ones(()))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_layer(arch="olmoe-1b-7b"):
    rcfg = rconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    tree = jax.tree_util.tree_map(
        np.asarray, rlm.init_model(jax.random.PRNGKey(0), rcfg)[0])
    model = convert.from_reference(cfg, tree, device="cpu")
    ref = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                 tree["blocks"][0]["ff"])
    return rcfg, cfg, ref, model.layers[0].ff


@pytest.fixture(scope="module")
def olmoe():
    return moe_layer()


MOE_CASES = [
    ("einsum", dict(dispatch="einsum")),
    ("scatter", dict(dispatch="scatter")),
    ("auto-einsum", dict(dispatch="auto")),
    ("grouped-scatter", dict(dispatch="scatter", groups=4)),
    ("grouped-einsum", dict(dispatch="einsum", groups=2)),
    ("drops-einsum", dict(dispatch="einsum", capacity_factor=0.5)),
    ("drops-scatter", dict(dispatch="scatter", capacity_factor=0.5)),
]


@pytest.mark.parametrize("name,kw", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_apply_moe(olmoe, name, kw):
    rcfg, cfg, ref, layer = olmoe
    x = rand(10, 2, 16, cfg.d_model)
    with torch.no_grad():
        got, aux = moe.apply_moe(layer, torch.tensor(x), cfg, **kw)
    want, raux = rmoe.apply_moe(ref, jnp.asarray(x), rcfg, **kw)
    close(got, want)
    np.testing.assert_array_equal(aux["capacity"].numpy(),
                                  np.asarray(raux["capacity"]))
    assert float(aux["overflow_frac"]) == float(raux["overflow_frac"])
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(raux["aux_loss"]), **TOL)
    if "drops" in name:
        assert float(aux["overflow_frac"]) > 0


def test_auto_takes_scatter_from_1024_tokens(olmoe, monkeypatch):
    rcfg, cfg, ref, layer = olmoe
    taken = []
    real = moe._moe_tokens
    monkeypatch.setattr(moe, "_moe_tokens", lambda p, x, c, cf, d: (
        taken.append(d) or real(p, x, c, cf, d)))
    x = rand(11, 4, 256, cfg.d_model)
    with torch.no_grad():
        got, _ = moe.apply_moe(layer, torch.tensor(x), cfg, dispatch="auto")
        moe.apply_moe(layer, torch.tensor(x[:, :255]), cfg, dispatch="auto")
    assert taken == ["scatter", "einsum"]
    close(got, rmoe.apply_moe(ref, jnp.asarray(x), rcfg, dispatch="auto")[0])


def test_shared_expert_moe():
    rcfg, cfg, ref, layer = moe_layer("llama4-scout-17b-a16e")
    x = rand(12, 2, 8, cfg.d_model)
    for dispatch in ("einsum", "scatter"):
        with torch.no_grad():
            got, _ = moe.apply_moe(layer, torch.tensor(x), cfg,
                                   dispatch=dispatch)
        close(got, rmoe.apply_moe(ref, jnp.asarray(x), rcfg,
                                  dispatch=dispatch)[0])


def test_set_dispatch_mode_and_groups(olmoe, monkeypatch):
    rcfg, cfg, ref, layer = olmoe
    monkeypatch.setattr(moe, "DISPATCH_MODE", moe.DISPATCH_MODE)
    monkeypatch.setattr(moe, "MOE_GROUPS", moe.MOE_GROUPS)
    moe.set_dispatch_mode("scatter")
    moe.set_moe_groups(2)
    assert (moe.DISPATCH_MODE, moe.MOE_GROUPS) == ("scatter", 2)
    x = rand(13, 2, 16, cfg.d_model)
    with torch.no_grad():
        got, aux = moe.apply_moe(layer, torch.tensor(x), cfg)
    close(got, rmoe.apply_moe(ref, jnp.asarray(x), rcfg, dispatch="scatter",
                              groups=2)[0])
    assert aux["capacity"].shape == (2,)
    moe.set_moe_groups(0)
    assert moe.MOE_GROUPS == 1
    with pytest.raises(ValueError):
        moe.set_dispatch_mode("dense")


def test_top_k_ties_take_the_lower_index_first():
    probs = np.array([[0.1, 0.3, 0.3, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.2, 0.1, 0.2, 0.5]], np.float32)
    vals, idx = moe.top_k(torch.tensor(probs), 2)
    rvals, ridx = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


def test_tied_router_keeps_the_reference_drops(olmoe):
    """Every token's router logits tie (a zero router): the choices are
    experts 0 and 1 in the reference's order, and at capacity 4 the same
    (token, choice) pairs are dropped."""
    rcfg, cfg, ref, layer = olmoe
    x = rand(14, 1, 12, cfg.d_model)
    ref = dict(ref, router=jnp.zeros_like(ref["router"]))
    tied = moe.MoE(cfg, device="meta")
    tied.load_state_dict(dict(layer.state_dict(),
                              router=torch.zeros_like(layer.router)),
                         assign=True)
    for dispatch in ("einsum", "scatter"):
        with torch.no_grad():
            got, aux = moe.apply_moe(tied, torch.tensor(x), cfg,
                                     dispatch=dispatch, capacity_factor=0.5)
        want, raux = rmoe.apply_moe(ref, jnp.asarray(x), rcfg,
                                    dispatch=dispatch, capacity_factor=0.5)
        assert float(aux["overflow_frac"]) == float(raux["overflow_frac"])
        assert float(aux["overflow_frac"]) > 0
        close(got, want)


def test_scatter_kept_slots_are_unique(olmoe):
    """Kept (token, choice) pairs land in distinct buffer slots, so only
    the sentinel row takes duplicate writes."""
    rcfg, cfg, ref, layer = olmoe
    xf = torch.tensor(rand(15, 64, cfg.d_model))
    seen = {}
    real = torch.Tensor.__setitem__

    def spy(t, index, value):
        if t.dim() == 2 and t.shape[0] % cfg.moe_num_experts == 1:
            seen["slot"] = index.clone()
            seen["rows"] = t.shape[0]
        return real(t, index, value)

    with torch.no_grad():
        torch.Tensor.__setitem__ = spy
        try:
            moe._moe_tokens(layer, xf, cfg, 0.5, "scatter")
        finally:
            torch.Tensor.__setitem__ = real
    sentinel = seen["rows"] - 1
    kept = seen["slot"][seen["slot"] != sentinel]
    assert len(kept) < len(seen["slot"])           # some dropped at cf 0.5
    assert len(torch.unique(kept)) == len(kept)


# ---------------------------------------------------------------------------
# Capacity calibration (host numpy, field for field)
# ---------------------------------------------------------------------------

CAL_CASES = [
    dict(method="exact"),
    dict(method="sampled"),
    dict(method="sampled", validate=False, seed=3),
    dict(method="sampled", sample_ratio=0.1, sigma=1.0, expansion=1.3),
]


@pytest.mark.parametrize("kw", CAL_CASES)
def test_calibrate_capacity(kw):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((20_000, 16)).astype(np.float32)
    logits[:, 0] += 1.5
    got = moe.calibrate_capacity(logits, 2, **kw)
    want = rmoe.calibrate_capacity(logits, 2, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
