"""The port's three model families beyond GQA — Mamba (Falcon-Mamba,
Jamba), MLA (MiniCPM3) and the encoder-decoder (Whisper) — against the
JAX reference, on the CPU.

Parameters are the reference's (``repro.models.lm.init_model`` at the
smoke configs, carried with ``repro_torch.models.convert``); inputs come
from numpy seeds; f32 on both sides. Every output, cache and logit
matches to rtol 1e-4 / atol 1e-5, as the other LM tests (other summation
orders; the Mamba scan groups its products as the reference's
``associative_scan``). Module by module: ``apply_mamba`` in train,
prefill and decode at 7, 256 and 300 tokens (one chunk, exactly one, a
padded second chunk); ``apply_mla`` in train, prefill and 8 absorbed
decode steps with and without a decode window; cross-attention, the
encoder, and ``apply_encdec`` in train, prefill and decode; both
packages' refusal to prefill the encoder-decoder through
``make_prefill_step``. The encoder-decoder's train step and ``convert``
of its trees are in ``test_torch_lm_families_train.py``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import mamba as rmamba  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, convert, lm, mamba  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def reference_model(arch, seed=0):
    rcfg = rconfigs.get_config(arch, smoke=True)
    rparams, _ = rlm.init_model(jax.random.PRNGKey(seed), rcfg)
    cfg = configs.get_config(arch, smoke=True)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, rparams, cfg, convert.from_reference(cfg, tree, "cpu")


@pytest.fixture(scope="module")
def falcon():
    return reference_model("falcon-mamba-7b")


@pytest.fixture(scope="module")
def minicpm3():
    return reference_model("minicpm3-4b")


@pytest.fixture(scope="module")
def whisper():
    return reference_model("whisper-base")


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **{**TOL, **kw})


def first_block(rparams, name):
    """Layer 0's ``name`` subtree of a scanned reference stack."""
    return jax.tree_util.tree_map(lambda a: a[0], rparams["blocks"][0][name])


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [7, 256, 300])
def test_apply_mamba_matches_reference(falcon, length):
    """Train and prefill (output, and the ``{'conv', 'ssm'}`` cache: the
    state at the last real token, the padded steps carrying it
    unchanged, each tensor owning its storage), then 4 decode steps from
    that cache."""
    rcfg, rparams, cfg, model = falcon
    rp, p = first_block(rparams, "mixer"), model.layers[0].mixer
    x = normal((2, length + 4, cfg.d_model), length)
    xs, xd = x[:, :length], x[:, length:]
    want, _ = rmamba.apply_mamba(rp, jnp.asarray(xs), rcfg, mode="train")
    with torch.no_grad():
        got, none = mamba.apply_mamba(p, torch.tensor(xs), cfg)
    assert none is None
    close(got, want)
    rcache = rmamba.init_mamba_cache(rcfg, 2, jnp.float32)
    cache = mamba.init_mamba_cache(cfg, 2, torch.float32, "cpu")
    want, rcache = rmamba.apply_mamba(rp, jnp.asarray(xs), rcfg,
                                      cache=rcache, mode="prefill")
    with torch.no_grad():
        got, cache = mamba.apply_mamba(p, torch.tensor(xs), cfg,
                                       cache=cache, mode="prefill")
    close(got, want)
    assert cache["ssm"].dtype == torch.float32
    for n in ("conv", "ssm"):
        close(cache[n], rcache[n], err_msg=n)
        # storage of its own: a view into the conv input or a chunk's
        # (B, chunk, di, ds) history would keep that buffer alive with
        # the cache, every layer's at once after a prefill
        t = cache[n]
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), n
    for j in range(xd.shape[1]):
        want, rcache = rmamba.apply_mamba(rp, jnp.asarray(xd[:, j:j + 1]),
                                          rcfg, cache=rcache, mode="decode")
        with torch.no_grad():
            got, cache = mamba.apply_mamba(p, torch.tensor(xd[:, j:j + 1]),
                                           cfg, cache=cache, mode="decode")
        close(got, want, err_msg=f"decode {j}")
    for n in ("conv", "ssm"):
        close(cache[n], rcache[n], err_msg=n)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_the_linear_recurrence(n):
    """The scan of (a, b) pairs equals h_t = a_t h_{t-1} + b_t (the
    recursion's odd and even branches at each length), and the reference's
    ``lax.associative_scan`` to the bit: the products group alike."""
    a = np.exp(-np.abs(normal((2, n, 3, 4), n)))
    b = normal((2, n, 3, 4), n + 1)
    got = mamba.associative_scan((torch.tensor(a), torch.tensor(b)))
    h, want = np.zeros((2, 3, 4), np.float32), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    close(got[1], np.stack(want, 1))
    ref = jax.lax.associative_scan(
        lambda e1, e2: (e2[0] * e1[0], e2[0] * e1[1] + e2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_softplus_is_jax_softplus():
    """Within one f32 rounding of ``jax.nn.softplus`` everywhere (XLA
    flushes the subnormal ``softplus(-100)`` to 0, hence the atol)."""
    x = np.array([-100.0, -3.0, 0.0, 1e-3, 5.0, 19.0, 20.0, 21.0, 50.0],
                 np.float32)
    np.testing.assert_allclose(
        mamba.softplus(torch.tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1.2e-7,
        atol=1e-38)


def test_mamba_state_is_the_slot_own(falcon):
    """Prefill and a decode step touch each row's own state only: another
    input in row 0 leaves row 1's output and state bit for bit."""
    _, _, cfg, model = falcon
    p = model.layers[0].mixer
    x = torch.tensor(normal((2, 9, cfg.d_model), 3))
    other = x.clone()
    other[0] = torch.tensor(normal((9, cfg.d_model), 4))
    runs = []
    with torch.no_grad():
        for inp in (x, other):
            _, cache = mamba.apply_mamba(
                p, inp[:, :8], cfg, mode="prefill",
                cache=mamba.init_mamba_cache(cfg, 2, torch.float32, "cpu"))
            out, cache = mamba.apply_mamba(p, inp[:, 8:], cfg, cache=cache,
                                           mode="decode")
            runs.append((out, cache))
    (out_a, cache_a), (out_b, cache_b) = runs
    assert not torch.equal(out_a[0], out_b[0])
    assert torch.equal(out_a[1], out_b[1])
    for n in ("conv", "ssm"):
        assert torch.equal(cache_a[n][1], cache_b[n][1]), n


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
def test_apply_mla_matches_reference(minicpm3, window):
    """Train over 24 tokens (no window, as the reference ignores it
    there), prefill of 16 into a 24-slot latent cache, then 8 absorbed
    decode steps under ``window``; the caches after."""
    rcfg, rparams, cfg, model = minicpm3
    rp, p = first_block(rparams, "mixer"), model.layers[0].mixer
    x = normal((2, 24, cfg.d_model), 20 + window)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    want, _ = rattn.apply_mla(rp, jnp.asarray(x), rcfg,
                              positions=jnp.asarray(pos), window=window)
    with torch.no_grad():
        got, _ = attention.apply_mla(p, torch.tensor(x), cfg,
                                     positions=torch.tensor(pos).long(),
                                     window=window)
    close(got, want)
    rcache = rtf.init_layer_cache(rcfg, rtf.LayerKind("attn", window,
                                                      "dense"),
                                  2, 24, jnp.float32)
    cache = tf.init_layer_cache(cfg, tf.LayerKind("attn", window, "dense"),
                                2, 24, torch.float32, "cpu")
    assert set(cache) == {"kv_lat", "k_rope"}
    want, rcache = rattn.apply_mla(rp, jnp.asarray(x[:, :16]), rcfg,
                                   positions=jnp.asarray(pos[:, :16]),
                                   cache=rcache, mode="prefill",
                                   window=window)
    with torch.no_grad():
        got, cache = attention.apply_mla(
            p, torch.tensor(x[:, :16]), cfg,
            positions=torch.tensor(pos[:, :16]).long(), cache=cache,
            mode="prefill", window=window)
    close(got, want)
    for j in range(16, 24):
        lens = np.full((2,), j, np.int32)
        want, rcache = rattn.apply_mla(
            rp, jnp.asarray(x[:, j:j + 1]), rcfg,
            positions=jnp.asarray(lens[:, None]), cache=rcache,
            cache_len=jnp.asarray(lens), mode="decode", window=window)
        with torch.no_grad():
            got, cache = attention.apply_mla(
                p, torch.tensor(x[:, j:j + 1]), cfg,
                positions=torch.tensor(lens[:, None]).long(), cache=cache,
                cache_len=torch.tensor(lens).long(), mode="decode",
                window=window)
        close(got, want, err_msg=f"decode {j}")
    for n in ("kv_lat", "k_rope"):
        close(cache[n], rcache[n], err_msg=n)


def test_mla_decode_equals_full_attention(minicpm3):
    """Without a window the absorbed decode equals the train mode's
    rebuilt K/V at the same position (f32, 1e-4)."""
    _, _, cfg, model = minicpm3
    p = model.layers[0].mixer
    x = torch.tensor(normal((2, 12, cfg.d_model), 30))
    pos = torch.arange(12).expand(2, 12)
    with torch.no_grad():
        full, _ = attention.apply_mla(p, x, cfg, positions=pos)
        cache = tf.init_layer_cache(cfg, tf.LayerKind("attn", 0, "dense"),
                                    2, 12, torch.float32, "cpu")
        _, cache = attention.apply_mla(p, x[:, :11], cfg,
                                       positions=pos[:, :11], cache=cache,
                                       mode="prefill")
        last, _ = attention.apply_mla(p, x[:, 11:], cfg, positions=pos[:, 11:],
                                      cache=cache,
                                      cache_len=torch.full((2,), 11),
                                      mode="decode")
    close(last, full[:, 11:].numpy())


# ---------------------------------------------------------------------------
# Cross-attention, the encoder, the encoder-decoder
# ---------------------------------------------------------------------------

def test_cross_attention_and_encoder(whisper):
    """``encode_cross_kv`` and ``apply_cross_attention`` of decoder layer
    0 on 40 frames; ``apply_encoder`` (non-causal layers) on the same."""
    rcfg, rparams, cfg, model = whisper
    enc = normal((2, 40, cfg.d_model), 40)
    x = normal((2, 6, cfg.d_model), 41)
    rkv = rattn.encode_cross_kv(rparams["cross"][0], jnp.asarray(enc), rcfg)
    with torch.no_grad():
        kv = attention.encode_cross_kv(model.cross[0], torch.tensor(enc), cfg)
        for n in ("k", "v"):
            close(kv[n], rkv[n])
        got = attention.apply_cross_attention(model.cross[0],
                                              torch.tensor(x), kv, cfg)
        out = tf.apply_encoder(model, torch.tensor(enc), cfg, remat="none")
    close(got, rattn.apply_cross_attention(rparams["cross"][0],
                                           jnp.asarray(x), rkv, rcfg))
    close(out, rtf.apply_encoder(rparams, jnp.asarray(enc), rcfg,
                                 remat="none"))


def test_encoder_is_not_causal(whisper):
    """The last frame changes the encoder's first output (it would not
    under a causal mask)."""
    _, _, cfg, model = whisper
    enc = torch.tensor(normal((1, 10, cfg.d_model), 42))
    other = enc.clone()
    other[:, -1] += 1.0
    with torch.no_grad():
        a = tf.apply_encoder(model, enc, cfg, remat="none")
        b = tf.apply_encoder(model, other, cfg, remat="none")
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3


def test_apply_encdec_matches_reference(whisper):
    """Train (the full forward over 12 tokens of 1,100 frames: the
    chunked core for the encoder and the cross-attention), prefill of 8
    tokens into a 16-slot cache with the cross K/V, then 4 decode steps
    through ``make_encdec_decode_step``: each step's logits against the
    reference's step and against the full forward; the caches after."""
    rcfg, rparams, cfg, model = whisper
    audio = normal((2, 1100, cfg.d_model), 43)
    toks = np.random.default_rng(44).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    rfull, _, _ = rtf.apply_encdec(rparams, jnp.asarray(audio),
                                   jnp.asarray(toks), rcfg)
    with torch.no_grad():
        full, none, aux = tf.apply_encdec(model, torch.tensor(audio),
                                          torch.tensor(toks).long(), cfg)
    assert none is None and float(aux) == 0.0
    close(full, rfull)
    rcache = rlm.init_caches(rcfg, 2, 16, dtype=jnp.float32, src_len=1100)
    cache = lm.init_caches(cfg, 2, 16, dtype=torch.float32, device="cpu",
                           src_len=1100)
    assert cache["cross"][0]["k"].shape == (2, 1100, cfg.num_kv_heads,
                                            cfg.head_dim_)
    want, rcache, _ = rtf.apply_encdec(rparams, jnp.asarray(audio),
                                       jnp.asarray(toks[:, :8]), rcfg,
                                       mode="prefill", caches=rcache)
    with torch.no_grad():
        got, cache, _ = tf.apply_encdec(model, torch.tensor(audio),
                                        torch.tensor(toks[:, :8]).long(),
                                        cfg, mode="prefill", caches=cache)
    close(got, want)
    close(got, full[:, :8].numpy())
    rdec = jax.jit(rlm.make_encdec_decode_step(rcfg))
    dec = lm.make_encdec_decode_step(cfg)
    for j in range(8, 12):
        want, rcache = rdec(rparams, rcache, jnp.asarray(toks[:, j:j + 1]),
                            jnp.full((2,), j, jnp.int32))
        got, cache = dec(model, cache, torch.tensor(toks[:, j:j + 1]).long(),
                         torch.full((2,), j))
        close(got, want, err_msg=f"decode {j}")
        close(got, full[:, j].numpy(), err_msg=f"decode {j} vs full")
    want = convert.caches_from_reference(cfg, rcache, "cpu")
    for part in ("self", "cross"):
        for got_l, want_l in zip(cache[part], want[part]):
            for n in ("k", "v"):
                close(got_l[n], want_l[n].numpy(), err_msg=part)


# ---------------------------------------------------------------------------
# Refusals, import hygiene
# ---------------------------------------------------------------------------

def test_both_prefill_steps_refuse_the_encoder_decoder(whisper):
    """The reference's ``make_prefill_step`` passes the tokens as the
    audio and fails (``src/repro/models/lm.py:190-195``); the port's
    refuses at once and names the prefill that works."""
    rcfg, rparams, cfg, model = whisper
    rcache = rlm.init_caches(rcfg, 1, 8, dtype=jnp.float32)
    with pytest.raises(ValueError):
        rlm.make_prefill_step(rcfg)(rparams, rcache,
                                    jnp.zeros((1, 4), jnp.int32))
    with pytest.raises(ValueError, match=r"lm\.py:190-195.*apply_encdec"):
        lm.make_prefill_step(cfg)
    with pytest.raises(ValueError, match="EncDec"):
        tf.Decoder(cfg, device="meta")


def test_new_families_import_neither_jax_nor_reference():
    """``models/mamba.py`` and the three families' steps run with neither
    JAX nor the reference loaded."""
    code = (
        "import sys, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import lm, mamba, transformer as tf\n"
        "for arch in ('falcon-mamba-7b', 'jamba-v0.1-52b', 'minicpm3-4b'):\n"
        "    cfg = configs.get_config(arch, smoke=True)\n"
        "    m = lm.init_model(cfg, device='cpu')\n"
        "    c = lm.init_caches(cfg, 1, 8, dtype=torch.float32, "
        "device='cpu')\n"
        "    lo, c = lm.make_prefill_step(cfg)(m, c, torch.tensor([[1, 2]]))\n"
        "    lo, c = lm.make_decode_step(cfg)(m, c, torch.tensor([[3]]), "
        "torch.tensor([2]))\n"
        "cfg = configs.get_config('whisper-base', smoke=True)\n"
        "m = lm.init_model(cfg, device='cpu')\n"
        "c = lm.init_caches(cfg, 1, 8, dtype=torch.float32, device='cpu', "
        "src_len=5)\n"
        "_, c, _ = tf.apply_encdec(m, torch.zeros(1, 5, cfg.d_model), "
        "torch.tensor([[1, 2]]), cfg, mode='prefill', caches=c)\n"
        "lo, c = lm.make_encdec_decode_step(cfg)(m, c, torch.tensor([[3]]), "
        "torch.tensor([2]))\n"
        "assert lo.shape == (1, cfg.vocab_size)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
