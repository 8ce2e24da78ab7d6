"""The port's training path against ``repro`` on the CPU (plain
kernels): dense (tinyllama), MoE (phi3.5-moe, with its aux loss) and
prefix embeddings (pixtral, whose patch positions are sliced off before
the loss), at ``reduced()`` sizes.  ``zoo.loss_fn``'s loss and every
leaf's gradient against ``jax.value_and_grad`` of ``repro``'s (default
``RunFlags``), and one ``make_train_step`` step at 1 and 2 microbatches
and with bf16 gradient accumulation (mixtral's rule) against
``repro``'s.  Tolerances: ``tests/_torch_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train as T  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import zoo as j_zoo  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402

ARCHS = ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b", "pixtral-12b"]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return T.setup(request.param)


def test_loss_and_grads_match_repro(run):
    want_loss, want = T.repro_grads(run)
    got_loss, got = T.port_grads(run)
    assert abs(got_loss - want_loss) <= T.LOSS_TOL
    T.check_tree(got, want, run["cfg"].name)


def test_blocked_and_naive_attention_agree_at_these_sizes(run):
    """The blocked-against-naive noise floor: ``repro``'s ``blocked`` and
    ``naive`` attention give the same loss and gradients here (one KV
    block), so their distance cannot set a limit (``_torch_train.py``)."""
    cfg = run["cfg"]
    out = []
    for impl in ("blocked", "naive"):
        fn = jax.value_and_grad(lambda p: j_zoo.loss_fn(
            p, run["jb"], cfg, j_lm.RunFlags(attn_impl=impl)), has_aux=True)
        out.append(jax.jit(fn)(run["params"]))
    (l0, _), g0 = out[0]
    (l1, _), g1 = out[1]
    assert float(l0) == float(l1)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_array_equal(T.f32(a), T.f32(b))


def test_loss_metrics_and_remat_off(run):
    """``loss_fn``'s metrics are ``repro``'s (``nll``, ``aux``), and the
    loss without remat equals it with remat (the recomputation repeats
    the forward exactly)."""
    batch = dict(run["tb"])
    loss, met = t_lm.loss_fn(run["model"], batch, run["t_cfg"])
    loss2, _ = t_lm.loss_fn(run["model"], batch, run["t_cfg"], remat=False)
    assert set(met) == {"nll", "aux"}
    assert torch.equal(loss, loss2)
    assert torch.allclose(loss, met["nll"] + 0.01 * met["aux"])
    if run["cfg"].family == "moe":
        assert float(met["aux"]) > 0
    else:
        assert float(met["aux"]) == 0.0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_repro(run, microbatches):
    T.check_step(run, microbatches)


def test_train_step_bf16_accumulation_matches_repro():
    """mixtral's rule (``TRAIN_ACCUM_DTYPE``): the microbatch gradients
    summed in bf16, on the reduced tinyllama."""
    T.check_step(T.setup("tinyllama-1.1b", seed=3), 2,
                 jaccum=jnp.bfloat16, taccum=torch.bfloat16)


def test_train_steps_lower_the_loss():
    """Three steps at a high learning rate on one batch: the loss falls,
    the parameters stay bf16 and keep their names, and the step counter
    advances."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    run = T.setup("tinyllama-1.1b", seed=5)
    model = run["model"]
    names = [n for n, _ in model.named_parameters()]
    step = steps.make_train_step(run["t_cfg"], adamw.AdamWConfig(
        peak_lr=3e-2, warmup_steps=0), microbatches=2)
    opt = adamw.init(model.tree())
    losses = []
    for _ in range(3):
        opt, out = step(model, opt, run["tb"])
        losses.append(float(out["loss"]))
    assert losses[2] < losses[0] and int(opt.step) == 3
    assert [n for n, _ in model.named_parameters()] == names
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in model.parameters())
