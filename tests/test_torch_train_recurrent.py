"""The port's training path against ``repro`` on the CPU for the
recurrent and encoder-decoder families: falcon-mamba (the selective
scan's plain version, differentiated by autograd), recurrentgemma (the
RG-LRU's plain version: ``fma_f32``'s exact partials) and whisper
(``encdec.encode`` / ``decode_train`` / ``loss_fn``), at ``reduced()``
sizes: ``zoo.loss_fn``'s loss and gradients, and one ``make_train_step``
step at 1 and 2 microbatches.  Tolerances: ``tests/_torch_train.py``;
``decode_train``'s hidden states within ``tests/test_torch_lm.py``'s
layer limit of four bf16 ulps at |x| < 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train as T  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b", "whisper-small"]
#: hidden states of the reduced decoder (|x| < 4): four bf16 ulps there
HIDDEN_TOL = 0.0625


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return T.setup(request.param)


def test_loss_and_grads_match_repro(run):
    want_loss, want = T.repro_grads(run)
    got_loss, got = T.port_grads(run)
    assert abs(got_loss - want_loss) <= T.LOSS_TOL
    T.check_tree(got, want, run["cfg"].name)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_repro(run, microbatches):
    T.check_step(run, microbatches)


@pytest.mark.parametrize("remat", [True, False])
def test_whisper_decode_train_matches_repro(remat):
    """The teacher-forced decoder over ``repro``'s encoder output: the
    hidden states after the final norm, with and without remat (which
    must not change them)."""
    run = T.setup("whisper-small", seed=1)
    cfg, params, jb = run["cfg"], run["params"], run["jb"]
    enc = j_encdec.encode(params, jb["frames"], cfg)
    want = j_encdec.decode_train(params, enc, jb["tokens"], cfg)
    enc_t = torch.from_numpy(T.f32(enc)).to(torch.bfloat16)
    got = t_encdec.decode_train(run["model"], enc_t, run["tb"]["tokens"],
                                run["t_cfg"], remat=remat)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert np.abs(T.f32(got) - T.f32(want)).max() <= HIDDEN_TOL
    got_enc = t_encdec.encode(run["model"], run["tb"]["frames"],
                              run["t_cfg"], remat=remat)
    assert np.abs(T.f32(got_enc) - T.f32(enc)).max() <= HIDDEN_TOL


def test_whisper_loss_fn_metrics():
    run = T.setup("whisper-small", seed=2)
    loss, met = t_encdec.loss_fn(run["model"], run["tb"], run["t_cfg"])
    (want, wmet) = j_encdec.loss_fn(run["params"], run["jb"], run["cfg"])
    assert set(met) == set(wmet) == {"nll", "aux"}
    assert float(met["aux"]) == float(wmet["aux"]) == 0.0
    assert abs(float(loss) - float(want)) <= T.LOSS_TOL
    assert torch.equal(loss, met["nll"])
