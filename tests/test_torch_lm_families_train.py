"""The encoder-decoder's train step and the weight carrier of the three
model families beyond GQA, against the JAX reference, on the CPU.

As ``test_torch_lm_families.py``: the reference's parameters at the smoke
configs, carried with ``repro_torch.models.convert``, inputs from numpy
seeds, f32. ``make_encdec_train_step`` is held to the reference's step
under the bounds of ``test_torch_lm_train.py`` (loss and grad norm rtol
1e-5, each gradient leaf within 1e-5 of its largest |g|, the updated
params and moments by the per-entry bounds derived from the two
gradients); ``convert`` maps the encoder-decoder's lists and an AdamW
state name for name, and ``cast_weights`` casts the new projections once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import lm as rlm  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.optim import adamw_init as radamw_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from test_torch_lm_families import normal, reference_model  # noqa: E402


@pytest.fixture(scope="module")
def whisper():
    return reference_model("whisper-base")


# ---------------------------------------------------------------------------
# The encoder-decoder's train step
# ---------------------------------------------------------------------------

def test_encdec_train_step_matches_reference(whisper):
    """One step of ``make_encdec_train_step`` from zero AdamW state on 2 x
    (64 frames, 17 tokens): loss and grad norm rtol 1e-5, every gradient
    leaf within 1e-5 of its largest |g|, the updated params and moments
    under the per-entry bounds of ``test_torch_lm_train.check_step``."""
    from test_torch_lm_train import LR, SCHEDULE, check_step, leafwise
    rcfg, rparams, cfg, _ = whisper
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    audio = normal((2, 64, cfg.d_model), 45)
    toks = np.random.default_rng(46).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    rbatch = {"audio_embeds": jnp.asarray(audio), "tokens": jnp.asarray(toks)}
    rstep = rlm.make_encdec_train_step(rcfg, RAdamWConfig(lr=LR),
                                       schedule_kwargs=SCHEDULE)

    def rloss(params):
        logits, _, _ = rtf.apply_encdec(params, rbatch["audio_embeds"],
                                        rbatch["tokens"][:, :-1], rcfg)
        return rlm.cross_entropy(logits, rbatch["tokens"][:, 1:])

    def both(params, state):
        # one compile, as test_torch_lm_train.reference_step: the gradient
        # that explains the step's update is the one compiled beside it
        return rstep(params, state, rbatch), jax.grad(rloss)(params)

    (rp, rstate, rmetrics), rgrads = jax.jit(both)(rparams,
                                                   radamw_init(rparams))
    rgrads = convert.reference_named(cfg, jax.tree_util.tree_map(
        np.asarray, rgrads))

    model = convert.from_reference(cfg, tree, "cpu")
    batch = {"audio_embeds": torch.tensor(audio), "tokens": torch.tensor(toks)}
    grads, loss, _ = lm.encdec_grads_of(model, batch, cfg)
    assert list(grads) == [n for n, _ in model.named_parameters()]
    assert sorted(grads) == sorted(rgrads)
    leafwise(grads, rgrads, 1e-5, "grad")
    np.testing.assert_allclose(float(loss), float(rmetrics["loss"]),
                               rtol=1e-5)
    step = lm.make_encdec_train_step(cfg, AdamWConfig(lr=LR),
                                     schedule_kwargs=SCHEDULE)
    state = adamw_init(model)
    out, state, metrics = step(model, state, batch)
    assert out is model and set(metrics) == {"loss", "grad_norm"}
    check_step(cfg, model, state, metrics,
               jax.tree_util.tree_map(np.asarray, rp), rstate, rmetrics,
               LR * float(rlm.cosine_schedule(jnp.asarray(0), **SCHEDULE)),
               grads=({n: g.numpy() for n, g in grads.items()}, rgrads))


# ---------------------------------------------------------------------------
# Weight carrier
# ---------------------------------------------------------------------------

def test_convert_encdec_tree_and_opt_state(whisper):
    """The encoder-decoder's lists land on ``encoder.i``, ``decoder.i``,
    ``cross.i`` and ``cross_ln.i``; a non-zero AdamW state on the same
    names; ``cast_weights`` keeps the model's class."""
    rcfg, rparams, cfg, model = whisper
    named = {n: p.detach() for n, p in model.named_parameters()}
    np.testing.assert_array_equal(named["decoder.1.mixer.wk"].numpy(),
                                  np.asarray(rparams["decoder"][1]["mixer"]
                                             ["wk"]))
    np.testing.assert_array_equal(named["cross.1.wv"].numpy(),
                                  np.asarray(rparams["cross"][1]["wv"]))
    np.testing.assert_array_equal(named["cross_ln.0"].numpy(),
                                  np.asarray(rparams["cross_ln"][0]))
    np.testing.assert_array_equal(named["encoder.0.ff.wi"].numpy(),
                                  np.asarray(rparams["encoder"][0]["ff"]
                                             ["wi"]))
    rng = np.random.default_rng(47)
    rstate = radamw_init(rparams)._replace(
        step=jnp.asarray(3, jnp.int32),
        mu=jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            radamw_init(rparams).mu),
        nu=jax.tree_util.tree_map(
            lambda a: rng.random(a.shape).astype(np.float32),
            radamw_init(rparams).nu))
    state = convert.opt_state_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, rstate), "cpu")
    assert int(state.step) == 3
    assert sorted(state.mu) == sorted(named) == sorted(state.nu)
    np.testing.assert_array_equal(state.nu["cross.0.wq"].numpy(),
                                  np.asarray(rstate.nu["cross"][0]["wq"]))
    half = lm.cast_weights(model, torch.bfloat16)
    assert isinstance(half, tf.EncDec)
    assert half.cross[0].wq.dtype == torch.bfloat16
    assert half.cross_ln[0].dtype == torch.float32


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "minicpm3-4b"])
def test_cast_weights_new_families(arch):
    """The Mamba and MLA projections are cast once, to the values each
    call would cast them to; their norms and SSM parameters stay f32."""
    cfg = configs.get_config(arch, smoke=True)
    model = lm.init_model(cfg, device="cpu")
    half = lm.cast_weights(model, torch.bfloat16)
    names = set()
    for (n, p), q in zip(model.named_parameters(), half.parameters()):
        leaf = n.rsplit(".", 1)[-1]
        if leaf in lm.MATMUL_WEIGHTS:
            names.add(leaf)
            assert torch.equal(q, p.to(torch.bfloat16)), n
        else:
            assert q.dtype == torch.float32, n
    want = ({"in_proj", "x_proj", "dt_proj", "out_proj", "conv_w"}
            if arch == "falcon-mamba-7b" else
            {"wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo", "wi", "wg"})
    assert want <= names
