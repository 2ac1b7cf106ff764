"""The port's LM training step (chunked loss, remat, microbatches, AdamW
through ``make_train_step``) against the JAX reference, on the CPU.

Both packages start from the reference's parameters (carried with
``repro_torch.models.convert``) and the same tokens (numpy seeds), in f32.
Tolerances, stated before the first run:

* ``chunked_cross_entropy``: value rtol 1e-5; its gradients within 1e-5 of
  the largest |g| of the same tensor.
* One train step: loss, aux and grad norm rtol 1e-5 (under bf16 gradient
  compression the grad norm rtol 1e-4: an entry whose two f32 gradients
  round to neighbouring bf16 values moves the norm). Each gradient leaf
  within 1e-5 of that leaf's largest |g|; the reference gradient is
  ``jax.grad`` of the loss that the reference's ``loss_fn`` builds from
  ``lm._apply`` and ``lm.chunked_cross_entropy``. One exception, found
  in the first run: under top-1 routing (Llama-4's smoke config) the
  normalized gate ``p / p`` is identically 1, so its derivative reaches
  the router only as the rounding residue of ``d(p / p)``, which each
  framework rounds its own way; the reference's residue alone is 1.8e-5
  of the leaf's largest |g| (the port's 2.9e-6). There the router is held
  to its exact gradient, the reference's gradient of the aux term alone
  (``0.01 * aux``), within the same 1e-5, and the reference's full
  gradient to that within 1e-4.
* The updated params, one step from a zero AdamW state: Adam's first step
  maps a clipped gradient x to ``x / (|x| + eps)``, about ``sign(x)``, so
  a near-zero gradient that the two packages sum to opposite signs moves
  a parameter by up to ``2 * lr`` (``lr`` = the config's lr times the
  schedule's scale). Every entry lies within ``2 * lr`` plus 1e-6 of the
  leaf's largest |p|; ``mu`` within 3e-5 and ``nu`` within 5e-5 of the
  leaf's largest value (the gradient tolerance carried through the clip's
  scale, and squared); under bf16 compression ``mu`` within 2^-7 (one
  bf16 spacing of the largest entry) and ``nu`` within 2^-6. Where both
  packages' gradients are at hand (the per-config test), each entry is
  held to what those gradients explain: with ``x_p``, ``x_r`` the two
  clipped gradients, ``|dp| <= lr * (B + 1e-6)`` plus the rounding above,
  ``B = |x_p - x_r| * eps / (min(|x_p|, |x_r|) + eps)^2`` (the slope
  bound of ``x / (|x| + eps)``) or 2 where the signs differ;
  ``|dmu| <= 0.1 |x_p - x_r|`` and ``|dnu| <= 0.05 |x_p^2 - x_r^2|``, each
  plus 1e-6 of the leaf's largest value. (The first statement bounded
  ``dp`` by ``lr / 100`` wherever the reference gradient exceeded 3e-5 of
  the leaf's largest |g|; that ignores entries with ``|x|`` near
  ``eps``, where the first run found a top-1 router entry at 4 eps.)
* Remat 'none', 'full' and 'dots' give the same loss and gradients within
  1e-6 (relative, of each leaf's largest |g|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.optim import adamw_init as radamw_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, lm, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

DECODER_ARCHS = ("qwen3-1.7b", "gemma3-1b", "granite-3-8b", "qwen2-vl-72b",
                 "llama4-scout-17b-a16e", "olmoe-1b-7b", "falcon-mamba-7b",
                 "jamba-v0.1-52b", "minicpm3-4b")
LR = 1e-2
SCHEDULE = {"warmup": 2, "total": 10}   # step 0 scales lr by 1/2


def reference(arch, seed=0):
    rcfg = rconfigs.get_config(arch, smoke=True)
    rparams, _ = rlm.init_model(jax.random.PRNGKey(seed), rcfg)
    cfg = configs.get_config(arch, smoke=True)
    return rcfg, rparams, cfg, jax.tree_util.tree_map(np.asarray, rparams)


def tokens_of(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def reference_step(rcfg, opt, *, with_grads=True, **kw):
    """The reference's jitted train step and, with ``with_grads``, the
    gradient of the loss its ``loss_fn`` builds, in one compile."""
    step = rlm.make_train_step(rcfg, opt, schedule_kwargs=SCHEDULE, **kw)
    remat = kw.get("remat", "dots")

    def total(params, tokens):
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        hidden, _, aux = rlm._apply(params, inputs, rcfg, mode="train",
                                    remat=remat, return_hidden=True)
        loss = rlm.chunked_cross_entropy(params, hidden, labels, rcfg)
        return loss + 0.01 * aux

    def aux_only(params, tokens):
        _, _, aux = rlm._apply(params, tokens[:, :-1], rcfg, mode="train",
                               remat=remat, return_hidden=True)
        return 0.01 * aux

    def both(params, opt_state, tokens):
        out = step(params, opt_state, {"tokens": tokens})
        if not with_grads:
            return out, None
        grads = {"total": jax.grad(total)(params, tokens)}
        if rcfg.moe_top_k == 1:
            grads["aux_only"] = jax.grad(aux_only)(params, tokens)
        return out, grads

    return jax.jit(both)


def reference_grads(cfg, grads):
    """The reference gradient by port names, a top-1 router's its exact
    one (the module docstring)."""
    named = {k: convert.reference_named(cfg, jax.tree_util.tree_map(
        np.asarray, g)) for k, g in grads.items()}
    out = named["total"]
    if "aux_only" in named:
        for n, g in named["aux_only"].items():
            if n.endswith("ff.router"):
                np.testing.assert_allclose(out[n], g, rtol=0,
                                           atol=1e-4 * np.abs(g).max())
                out[n] = g
    return out


def leafwise(got, want, frac, what):
    for n, w in want.items():
        w = np.asarray(w)
        g = got[n].detach().numpy()
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= frac * float(np.abs(w).max()) + 1e-30, \
            f"{what} {n}: {err} > {frac} x {float(np.abs(w).max())}"


def check_step(cfg, model, state, metrics, rparams_new, rstate, rmetrics,
               lr, grads=None, bf16=False):
    """Hold one port step to the reference's, as the docstring states;
    ``grads``: the (port, reference) gradients by name that drove the two
    updates, for the per-entry bounds. Metrics the reference's step does
    not return (the encoder-decoder's: no aux, no lr scale) are not
    compared."""
    assert set(metrics) == set(rmetrics)
    for k in ("loss", "aux_loss"):
        if k in rmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                       rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(rmetrics["grad_norm"]),
                               rtol=1e-4 if bf16 else 1e-5)
    if "lr_scale" in rmetrics:
        np.testing.assert_allclose(float(metrics["lr_scale"]),
                                   float(rmetrics["lr_scale"]), rtol=1e-6)
    assert int(state.step) == int(rstate.step) == 1
    want_p = convert.reference_named(cfg, rparams_new)
    got_p = dict(model.named_parameters())
    for n, w in want_p.items():
        off = np.abs(got_p[n].detach().numpy() - w)
        assert off.max() <= 2 * lr + 1e-6 * np.abs(w).max(), (n, off.max())
    want_mu = convert.reference_named(cfg, rstate.mu)
    want_nu = convert.reference_named(cfg, rstate.nu)
    leafwise(state.mu, want_mu, 2 ** -7 if bf16 else 3e-5, "mu")
    leafwise(state.nu, want_nu, 2 ** -6 if bf16 else 5e-5, "nu")
    if grads is None:
        return
    eps = AdamWConfig().eps
    scales = [np.float32(min(1.0, 1.0 / float(m["grad_norm"])))
              for m in (metrics, rmetrics)]
    for n, w in want_p.items():
        xp, xr = (g[n] * sc for g, sc in zip(grads, scales))
        dx = np.abs(xp - xr)
        slope = eps / (np.minimum(np.abs(xp), np.abs(xr)) + eps) ** 2
        bound = np.where(np.sign(xp) == np.sign(xr),
                         np.minimum(dx * slope, 2.0), 2.0)
        off = np.abs(got_p[n].detach().numpy() - w)
        ok = off <= lr * (bound + 1e-6) + 1e-6 * np.abs(w).max()
        assert ok.all(), (n, off[~ok], bound[~ok], xp[~ok], xr[~ok])
        for got, want, pred in (
                (state.mu[n], want_mu[n], 0.1 * dx),
                (state.nu[n], want_nu[n], 0.05 * np.abs(xp * xp - xr * xr))):
            err = np.abs(got.numpy() - want)
            ok = err <= pred + 1e-6 * np.abs(want).max()
            assert ok.all(), (n, err[~ok], pred[~ok])


# ---------------------------------------------------------------------------
# Chunked loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [6, 16, 21])
def test_chunked_cross_entropy(length):
    """Chunk 8: L below the chunk (one unembed), a multiple of it, and not
    a multiple (padded, masked); value and gradients w.r.t. the hidden
    states and the tied embedding."""
    rcfg, rparams, cfg, tree = reference("qwen3-1.7b")
    rng = np.random.default_rng(length)
    hidden = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, length)).astype(np.int32)

    def rloss(embed, h):
        p = dict(rparams, embed=embed)
        return rlm.chunked_cross_entropy(p, h, jnp.asarray(labels), rcfg,
                                         chunk=8)

    want, (wg_e, wg_h) = jax.value_and_grad(rloss, argnums=(0, 1))(
        rparams["embed"], jnp.asarray(hidden))
    model = convert.from_reference(cfg, tree, "cpu")
    h = torch.tensor(hidden, requires_grad=True)
    got = lm.chunked_cross_entropy(model, h, torch.tensor(labels).long(),
                                   cfg, chunk=8)
    g_e, g_h = torch.autograd.grad(got, [model.embed, h])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in ((g_e, wg_e), (g_h, wg_h)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_train_step_matches_reference(arch):
    """One train step (remat 'dots', the default) of a 2 x 17 batch from
    zero optimizer state: loss, aux, grad norm, every gradient leaf, the
    updated params and both moments."""
    rcfg, rparams, cfg, tree = reference(arch)
    toks = tokens_of(cfg, (2, 17))
    (rp, rstate, rmetrics), rgrads = reference_step(
        rcfg, RAdamWConfig(lr=LR))(rparams, radamw_init(rparams),
                                   jnp.asarray(toks))
    rfull = convert.reference_named(cfg, jax.tree_util.tree_map(
        np.asarray, rgrads["total"]))
    rgrads = reference_grads(cfg, rgrads)

    model = convert.from_reference(cfg, tree, "cpu")
    grads, loss, aux = lm.grads_of(model, torch.tensor(toks), cfg)
    assert list(grads) == [n for n, _ in model.named_parameters()]
    leafwise(grads, rgrads, 1e-5, "grad")
    np.testing.assert_allclose(float(loss), float(rmetrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(rmetrics["aux_loss"]),
                               rtol=1e-5)

    step = lm.make_train_step(cfg, AdamWConfig(lr=LR),
                              schedule_kwargs=SCHEDULE)
    state = adamw_init(model)
    out, state, metrics = step(model, state, {"tokens": torch.tensor(toks)})
    assert out is model
    check_step(cfg, model, state, metrics,
               jax.tree_util.tree_map(np.asarray, rp), rstate, rmetrics,
               LR * float(rmetrics["lr_scale"]),
               grads=({n: g.numpy() for n, g in grads.items()}, rfull))


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmoe-1b-7b",
                                  "falcon-mamba-7b"])
def test_remat_modes_agree(arch):
    """Falcon-Mamba's chunk checkpoints nest inside each layer's region."""
    _, _, cfg, tree = reference(arch)
    toks = torch.tensor(tokens_of(cfg, (2, 17), seed=2))
    model = convert.from_reference(cfg, tree, "cpu")
    base, loss0, aux0 = lm.grads_of(model, toks, cfg, remat="none")
    for remat in ("full", "dots"):
        grads, loss, aux = lm.grads_of(model, toks, cfg, remat=remat)
        np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
        np.testing.assert_allclose(float(aux), float(aux0), rtol=1e-6)
        leafwise(grads, {n: g.numpy() for n, g in base.items()}, 1e-6,
                 f"grad ({remat})")
    with pytest.raises(ValueError, match="remat"):
        lm.grads_of(model, toks, cfg, remat="some")


def test_dots_saves_only_products_without_batch_dims():
    """Under 'dots' the backward pass recomputes the batched products
    (bmm) and keeps the unbatched ones (mm)."""
    _, _, cfg, tree = reference("olmoe-1b-7b")
    model = convert.from_reference(cfg, tree, "cpu")
    toks = torch.tensor(tokens_of(cfg, (2, 9), seed=3))
    counts = {}
    for remat in ("none", "dots", "full"):
        seen = []

        class Count(torch.utils._python_dispatch.TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                seen.append(func)
                return func(*args, **(kwargs or {}))

        with Count():
            lm.grads_of(model, toks, cfg, remat=remat)
        counts[remat] = {f: seen.count(f) for f in
                         (torch.ops.aten.mm.default,
                          torch.ops.aten.bmm.default)}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"][mm] == counts["none"][mm] < counts["full"][mm]
    assert counts["none"][bmm] < counts["dots"][bmm] == counts["full"][bmm]


def test_microbatch_matches_reference():
    """5 rows in microbatches of 2: two slices accumulated, the fifth row
    dropped, as the reference's scan."""
    rcfg, rparams, cfg, tree = reference("qwen3-1.7b")
    toks = tokens_of(cfg, (5, 17), seed=4)
    (rp, rstate, rmetrics), _ = reference_step(
        rcfg, RAdamWConfig(lr=LR), remat="none", microbatch=2,
        with_grads=False)(rparams, radamw_init(rparams), jnp.asarray(toks))
    model = convert.from_reference(cfg, tree, "cpu")
    step = lm.make_train_step(cfg, AdamWConfig(lr=LR), remat="none",
                              microbatch=2, schedule_kwargs=SCHEDULE)
    _, state, metrics = step(model, adamw_init(model),
                             {"tokens": torch.tensor(toks)})
    check_step(cfg, model, state, metrics,
               jax.tree_util.tree_map(np.asarray, rp), rstate, rmetrics,
               LR * float(rmetrics["lr_scale"]))
    # the fifth row is dropped: changing it changes nothing
    other = toks.copy()
    other[4] = (other[4] + 1) % cfg.vocab_size
    again = convert.from_reference(cfg, tree, "cpu")
    _, _, m2 = step(again, adamw_init(again), {"tokens": torch.tensor(other)})
    assert float(m2["loss"]) == float(metrics["loss"])
    for p, q in zip(model.parameters(), again.parameters()):
        assert torch.equal(p, q)


def test_bf16_grad_compression_matches_reference():
    rcfg, rparams, cfg, tree = reference("olmoe-1b-7b")
    toks = tokens_of(cfg, (2, 17), seed=5)
    (rp, rstate, rmetrics), _ = reference_step(
        rcfg, RAdamWConfig(lr=LR, grad_compression="bf16"),
        with_grads=False)(rparams, radamw_init(rparams), jnp.asarray(toks))
    model = convert.from_reference(cfg, tree, "cpu")
    step = lm.make_train_step(cfg, AdamWConfig(lr=LR,
                                               grad_compression="bf16"),
                              schedule_kwargs=SCHEDULE)
    _, state, metrics = step(model, adamw_init(model),
                             {"tokens": torch.tensor(toks)})
    check_step(cfg, model, state, metrics,
               jax.tree_util.tree_map(np.asarray, rp), rstate, rmetrics,
               LR * float(rmetrics["lr_scale"]), bf16=True)


def test_olmoe_aux_and_drops_at_config_capacity():
    """OLMoE's first MoE layer on the train step's normed embeddings, at
    the config's capacity factor 1.25: capacity, dropped share (exactly)
    and aux loss (rtol 1e-5) as the reference's; tokens do drop."""
    rcfg, rparams, cfg, tree = reference("olmoe-1b-7b")
    toks = tokens_of(cfg, (2, 17), seed=6)[:, :-1]
    model = convert.from_reference(cfg, tree, "cpu")
    with torch.no_grad():
        x = model.embed[torch.tensor(toks).long()] * cfg.d_model ** 0.5
        h = rms_norm(x, model.layers[0].ln2 - 1.0, cfg.norm_eps)
        _, aux = moe.apply_moe(model.layers[0].ff, h, cfg)
    rx = rparams["embed"][jnp.asarray(toks)] * jnp.asarray(
        rcfg.d_model ** 0.5, rcfg.compute_dtype)
    rffp = jax.tree_util.tree_map(lambda a: a[0],
                                  rparams["blocks"][0]["ff"])
    rh = rtf.rms_norm(rx, rparams["blocks"][0]["ln2"][0] - 1.0,
                      rcfg.norm_eps)
    _, raux = rmoe.apply_moe(rffp, rh, rcfg)
    assert int(aux["capacity"]) == int(raux["capacity"]) == 10
    assert float(aux["overflow_frac"]) == float(raux["overflow_frac"]) > 0
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(raux["aux_loss"]), rtol=1e-5)


def test_train_step_leaves_no_grad_state():
    """The train step runs under autograd even when called from a no_grad
    block, leaves no ``.grad`` on the parameters, and the serving steps
    keep their ``no_grad``."""
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    model = lm.init_model(cfg, device="cpu")
    toks = torch.tensor(tokens_of(cfg, (2, 9), seed=7))
    step = lm.make_train_step(cfg, AdamWConfig(lr=LR))
    before = model.embed.detach().clone()
    with torch.no_grad():
        _, _, metrics = step(model, adamw_init(model), {"tokens": toks})
    assert not torch.equal(model.embed.detach(), before)
    assert all(p.grad is None for p in model.parameters())
    assert torch.isfinite(metrics["loss"])
    caches = lm.init_caches(cfg, 2, 16, dtype=torch.float32, device="cpu")
    logits, _ = lm.make_prefill_step(cfg)(model, caches, toks)
    assert not logits.requires_grad


def test_remat_is_for_training_only():
    cfg = configs.get_config("qwen3-1.7b", smoke=True)
    model = lm.init_model(cfg, device="cpu")
    caches = lm.init_caches(cfg, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="train mode"):
        tf.apply_decoder(model, torch.zeros((1, 4), dtype=torch.long), cfg,
                         mode="prefill", caches=caches, remat="full")


def test_opt_state_from_reference():
    """A non-zero reference AdamW state lands on the port's names."""
    rcfg, rparams, cfg, tree = reference("gemma3-1b")
    rng = np.random.default_rng(8)
    rstate = radamw_init(rparams)
    rstate = rstate._replace(
        step=jnp.asarray(5, jnp.int32),
        mu=jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            rstate.mu),
        nu=jax.tree_util.tree_map(
            lambda a: rng.random(a.shape).astype(np.float32), rstate.nu))
    state = convert.opt_state_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rstate), "cpu")
    model = convert.from_reference(cfg, tree, "cpu")
    assert int(state.step) == 5 and state.step.dtype == torch.int32
    names = [n for n, _ in model.named_parameters()]
    assert sorted(state.mu) == sorted(names) == sorted(state.nu)
    # scanned layer i is blocks[i % period][i // period]: gemma3's layer 7
    # is the tail's second
    np.testing.assert_array_equal(
        state.mu["layers.7.mixer.wq"].numpy(),
        np.asarray(rstate.mu["tail"][1]["mixer"]["wq"]))
    np.testing.assert_array_equal(
        state.nu["layers.4.ff.wo"].numpy(),
        np.asarray(rstate.nu["blocks"][4]["ff"]["wo"][0]))
    for n, p in model.named_parameters():
        assert state.mu[n].shape == p.shape
