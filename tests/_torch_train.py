"""Shared helpers of the training tests (``tests/test_torch_train*.py``):
one reduced config's weights, batch, ``repro``'s loss, gradients and
train steps, and the checks that hold the port's to them.

Tolerances (every family; the port runs its plain kernels on the CPU).
Both packages compute in bf16 with f32 statistics and round at other
places (XLA keeps excess precision inside a fusion, PyTorch rounds every
op), and every gradient passes through many bf16 roundings.  ``repro``'s
``blocked`` and ``naive`` attention give the same gradients bit for bit
at these sizes (a sequence is one KV block), so their distance is zero
and sets no limit; the noise floor is ``repro``'s own distance between a
batch's gradients and the f32 mean of its two half batches' (the
microbatch split), measured up to 5.3e-2 of a leaf's largest |g|
element-wise and 2.2e-2 of its norm normwise.  The port lies up to
5.0e-2 / 2.9e-2 from ``repro`` (recurrentgemma's norm scales; 1.9e-2 /
1.4e-2 for the dense, MoE and prefix models).  Limits: ``GRAD_MAX_TOL``
(2^-3) of the leaf's largest |g| element-wise, ``GRAD_NORM_TOL`` (2^-4)
of its norm normwise: over twice both.  The loss, a mean over the
tokens of ``logsumexp - gold logit`` whose logits (|x| < 4) agree to a
few bf16 ulps (2^-6 there; ``tests/test_torch_lm.py``): within
``LOSS_TOL`` = 2^-6 absolute (measured <= 1.9e-3).  After one AdamW step: ``m`` (proportional to g) as
the gradients, ``v`` (to g^2) at twice their normwise limit, ``master``
within ``2.5 lr`` (a small gradient's sign may differ, moving an element
by ``2 lr``), the bf16 parameters that plus one bf16 ulp, ``grad_norm``
``GNORM_RTOL`` (2^-6), ``lr`` as f32 arithmetic (``SCHED_RTOL``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get as j_get
from repro.launch import steps as j_steps
from repro.models import zoo as j_zoo
from repro.optim import adamw as j_adamw
from repro_torch.configs import get as t_get
from repro_torch.launch import steps as t_steps
from repro_torch.models import convert
from repro_torch.models import zoo as t_zoo
from repro_torch.optim import adamw as t_adamw

GRAD_MAX_TOL = 2.0 ** -3
GRAD_NORM_TOL = 2.0 ** -4
LOSS_TOL = 2.0 ** -6
GNORM_RTOL = 2.0 ** -6
SCHED_RTOL = 4 * 2.0 ** -23
#: batch rows and tokens a row of the reduced runs
B, S = 2, 32


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def setup(arch: str, seed: int = 0) -> dict:
    """The reduced config's ``repro`` weights and the port's model built
    from them, and one numpy-seeded batch in both packages' types."""
    cfg, t_cfg = j_get(arch).reduced(), t_get(arch).reduced()
    params = j_zoo.init_model(cfg, seed=seed)
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray, params),
                               t_cfg, device="cpu")
    rng = np.random.default_rng(seed + 11)
    host = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "targets": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.frontend == "vision":
        host["prefix_embeds"] = rng.normal(size=(B, cfg.n_patches,
                                                 cfg.d_model))
    if cfg.family == "encdec":
        host["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
    jb, tb = {}, {}
    for k, v in host.items():
        if v.dtype.kind == "f":
            jb[k] = jnp.asarray(v, jnp.float32).astype(jnp.bfloat16)
            tb[k] = torch.from_numpy(f32(jb[k])).to(torch.bfloat16)
        else:
            jb[k] = jnp.asarray(v, jnp.int32)
            tb[k] = torch.from_numpy(v.astype(np.int64))
    return {"cfg": cfg, "t_cfg": t_cfg, "params": params, "model": model,
            "jb": jb, "tb": tb}


def repro_grads(run: dict, batch=None):
    """``repro``'s ``(loss, grads)`` of ``zoo.loss_fn`` (default
    ``RunFlags``)."""
    cfg = run["cfg"]
    fn = jax.value_and_grad(lambda p, b: j_zoo.loss_fn(p, b, cfg),
                            has_aux=True)
    (loss, _), g = jax.jit(fn)(run["params"], run["jb"] if batch is None
                               else batch)
    return float(loss), g


def port_grads(run: dict):
    """The port's ``(loss, grads as repro's stacked tree of float32)``."""
    model = run["model"]
    tree = model.tree(data=False)
    loss, grads = t_steps._grads(model, run["tb"], run["t_cfg"],
                                 t_adamw.leaves(tree))
    return float(loss), convert.tree_to_repro(t_adamw.unflatten(tree,
                                                                grads))


def check_leaf(got, want, what, max_tol=GRAD_MAX_TOL,
               norm_tol=GRAD_NORM_TOL) -> None:
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    top, norm = np.abs(want).max(), np.linalg.norm(want)
    d = got - want
    assert np.abs(d).max() <= max_tol * top + 1e-30, (
        what, "element-wise", np.abs(d).max() / max(top, 1e-30))
    assert np.linalg.norm(d) <= norm_tol * norm + 1e-30, (
        what, "normwise", np.linalg.norm(d) / max(norm, 1e-30))


def check_tree(got: dict, want, what: str, **kw) -> None:
    paths = jax.tree_util.tree_leaves_with_path(want)
    leaves = jax.tree_util.tree_leaves(got)
    assert len(paths) == len(leaves)
    for (p, w), g in zip(paths, leaves):
        check_leaf(g, w, (what, jax.tree_util.keystr(p)), **kw)


def repro_step(run: dict, microbatches: int, accum=jnp.float32):
    cfg = run["cfg"]
    step = jax.jit(j_steps.make_train_step(
        cfg, j_adamw.AdamWConfig(), microbatches=microbatches,
        grad_accum_dtype=accum))
    params, opt, out = step(run["params"], j_adamw.init(run["params"]),
                            run["jb"])
    return params, opt, out


def port_step(run: dict, microbatches: int, accum=torch.float32):
    """One port train step on a fresh copy of the model; returns
    ``(model, opt_state, metrics)``."""
    model = convert.from_repro(jax.tree_util.tree_map(np.asarray,
                                                      run["params"]),
                               run["t_cfg"], device="cpu")
    step = t_steps.make_train_step(run["t_cfg"], t_adamw.AdamWConfig(),
                                   microbatches=microbatches,
                                   grad_accum_dtype=accum)
    opt, out = step(model, t_adamw.init(model.tree()), run["tb"])
    return model, opt, out


def check_step(run: dict, microbatches: int, jaccum=jnp.float32,
               taccum=torch.float32) -> None:
    """One train step of each package from the same weights and batch:
    the metrics, the new AdamW state and parameters (module
    docstring)."""
    jp, jo, jm = repro_step(run, microbatches, jaccum)
    model, to, tm = port_step(run, microbatches, taccum)
    assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
        GNORM_RTOL * float(jm["grad_norm"]))
    lr = float(jm["lr"])
    assert abs(float(tm["lr"]) - lr) <= SCHED_RTOL * lr
    got = convert.opt_to_repro(to)
    assert got["step"] == int(jo.step) == 1
    check_tree(got["m"], jo.m, "m")
    check_tree(got["v"], jo.v, "v", norm_tol=2 * GRAD_NORM_TOL,
               max_tol=2 * GRAD_MAX_TOL)
    for (p, w), g in zip(jax.tree_util.tree_leaves_with_path(jo.master),
                         jax.tree_util.tree_leaves(got["master"])):
        d = np.abs(f32(g) - f32(w)).max()
        assert d <= 2.5 * lr, ("master", jax.tree_util.keystr(p), d / lr)
    for (p, w), g in zip(jax.tree_util.tree_leaves_with_path(jp),
                         jax.tree_util.tree_leaves(
                             convert.to_repro(model))):
        w = f32(w)
        lim = 2.5 * lr + 2.0 ** -8 * np.abs(w)
        assert (np.abs(f32(g) - w) <= lim).all(), (
            "params", jax.tree_util.keystr(p))
