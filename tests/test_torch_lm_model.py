"""The port's LM model (configs, decoder stack, LM steps, weight carrier)
against the JAX reference, on the CPU.

The reference's parameters (``repro.models.lm.init_model``) are carried
to the port with ``repro_torch.models.convert``; tokens come from numpy
seeds. Logits of the nine decoder-only smoke configs (six GQA, then
Falcon-Mamba, Jamba and MiniCPM3) — full forward, prefill and each
decode step — and the caches after decoding (``{'k', 'v'}``,
``{'conv', 'ssm'}``, ``{'kv_lat', 'k_rope'}``) match the reference to
rtol 1e-4 / atol 1e-5 (f32 on both sides, other summation orders).
Parameter counts match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
GQA_ARCHS = ("qwen3-1.7b", "gemma3-1b", "granite-3-8b", "qwen2-vl-72b",
             "llama4-scout-17b-a16e", "olmoe-1b-7b")
DECODER_ARCHS = GQA_ARCHS + ("falcon-mamba-7b", "jamba-v0.1-52b",
                             "minicpm3-4b")


def reference_model(arch, seed=0):
    rcfg = rconfigs.get_config(arch, smoke=True)
    rparams, _ = rlm.init_model(jax.random.PRNGKey(seed), rcfg)
    cfg = configs.get_config(arch, smoke=True)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, rparams, cfg, convert.from_reference(cfg, tree, "cpu")


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_config_matches_reference(arch):
    for smoke in (False, True):
        got = configs.get_config(arch, smoke=smoke)
        want = rconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.compute_dtype == getattr(torch, want.dtype)
        assert configs.shape_skips(arch) == rconfigs.shape_skips(arch)


def test_registry_matches_reference():
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert configs.eligible_cells() == rconfigs.eligible_cells()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_arch("gpt-5")


# ---------------------------------------------------------------------------
# Decoder and LM steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_logits_match_reference(arch):
    """Full forward (mode train), prefill of 16 tokens and 8 decode steps
    of a 2-row batch; then the caches."""
    rcfg, rparams, cfg, model = reference_model(arch)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _, raux = rtf.apply_decoder(rparams, jnp.asarray(toks), rcfg)
    with torch.no_grad():
        got, _, aux = tf.apply_decoder(model, torch.tensor(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)

    rcache = rlm.init_caches(rcfg, 2, 40, dtype=jnp.float32)
    cache = lm.init_caches(cfg, 2, 40, dtype=torch.float32, device="cpu")
    rpre, rdec = (jax.jit(rlm.make_prefill_step(rcfg)),
                  jax.jit(rlm.make_decode_step(rcfg)))
    pre, dec = lm.make_prefill_step(cfg), lm.make_decode_step(cfg)
    want, rcache = rpre(rparams, rcache, jnp.asarray(toks[:, :16]))
    got, cache = pre(model, cache, torch.tensor(toks[:, :16]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for j in range(16, 24):
        want, rcache = rdec(rparams, rcache, jnp.asarray(toks[:, j:j + 1]),
                            jnp.full((2,), j, jnp.int32))
        got, cache = dec(model, cache, torch.tensor(toks[:, j:j + 1]),
                         torch.full((2,), j))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = convert.caches_from_reference(cfg, rcache, "cpu")
    assert len(cache) == len(want) == cfg.num_layers
    for got_l, want_l in zip(cache, want):
        assert sorted(got_l) == sorted(want_l)
        for n in want_l:
            np.testing.assert_allclose(got_l[n].numpy(), want_l[n].numpy(),
                                       err_msg=n, **TOL)


def test_float_embedding_inputs():
    rcfg, rparams, cfg, model = reference_model("qwen3-1.7b")
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    want, _, _ = rtf.apply_decoder(rparams, jnp.asarray(x), rcfg)
    with torch.no_grad():
        got, _, _ = tf.apply_decoder(model, torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gemma3_layer_mapping():
    """Gemma3's smoke stack: period 6 scanned once, then a 2-layer tail.
    Scanned layer i is blocks[i % 6][i // 6]; tail layer t is layer 6 + t."""
    rcfg, rparams, cfg, model = reference_model("gemma3-1b")
    plan = tf.StackPlan.from_config(cfg)
    assert (plan.period, plan.n_scan, len(plan.tail)) == (6, 1, 2)
    assert plan == tf.StackPlan(**dataclasses.asdict(
        rtf.StackPlan.from_config(rcfg)))
    for i, layer in enumerate(model.layers):
        if i < 6:
            want = rparams["blocks"][i % 6]["mixer"]["wq"][i // 6]
        else:
            want = rparams["tail"][i - 6]["mixer"]["wq"]
        np.testing.assert_array_equal(layer.mixer.wq.detach().numpy(),
                                      np.asarray(want))
        assert layer.kind.window == cfg.window_of(i)


def test_init_model_builds_all_ten():
    """Every architecture builds on the CPU: the encoder-decoder as an
    ``EncDec``, the rest as a ``Decoder`` whose layers hold the mixer of
    their kind."""
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, smoke=True)
        model = lm.init_model(cfg, device="cpu")
        assert isinstance(model, tf.model_class(cfg)), arch
        if cfg.is_encoder_decoder:
            assert len(model.encoder) == cfg.encoder_layers
            continue
        for layer, kind in zip(model.layers, tf.layer_kinds(cfg)):
            want = ("Mamba" if kind.mixer == "mamba" else
                    "MLA" if cfg.attention_type == "mla" else "GQA")
            assert type(layer.mixer).__name__ == want, arch


def test_init_model_seeded_on_its_device():
    cfg = configs.get_config("olmoe-1b-7b", smoke=True)
    a = lm.init_model(cfg, seed=3, device="cpu")
    b = lm.init_model(cfg, seed=3, device="cpu")
    c = lm.init_model(cfg, seed=4, device="cpu")
    rshapes = rlm.param_shapes(rconfigs.get_config("olmoe-1b-7b", True))
    assert sum(p.numel() for p in a.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(rshapes))
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert p.dtype == torch.float32 and p.device.type == "cpu"
        assert torch.equal(p, q), n
        if "norm" not in n and "ln" not in n:
            assert not torch.equal(p, r), n
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_model(cfg)


def test_cast_weights():
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    model = lm.init_model(cfg, device="cpu")
    assert lm.cast_weights(model, torch.float32) is model
    half = lm.cast_weights(model, torch.bfloat16)
    for (n, p), q in zip(model.named_parameters(), half.parameters()):
        if n.rsplit(".", 1)[-1] in lm.MATMUL_WEIGHTS:
            assert q.dtype == torch.bfloat16
            assert torch.equal(q, p.to(torch.bfloat16)), n
        else:
            assert q.data_ptr() == p.data_ptr(), n   # shared, f32


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7))
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    want = rlm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = lm.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                           None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_slice_and_update_caches():
    cfg = configs.get_config("gemma3-1b", smoke=True)
    caches = lm.init_caches(cfg, 3, 10, dtype=torch.float32, device="cpu")
    row = lm.slice_caches(caches, 1, 1)
    assert len(row) == cfg.num_layers and row[0]["k"].shape[0] == 1
    row[0]["k"].fill_(2.0)          # a view: writes into the slot's row
    assert float(caches[0]["k"][1].min()) == 2.0
    other = [{n: torch.full_like(c, 7.0, dtype=torch.bfloat16)
              for n, c in layer.items()} for layer in row]
    out = lm.update_caches(caches, other, 2)
    assert out is caches and caches[5]["v"].dtype == torch.float32
    assert float(caches[5]["v"][2].min()) == 7.0
    assert float(caches[5]["v"][0].abs().max()) == 0.0
