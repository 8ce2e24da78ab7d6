"""``repro``'s two XLA attention strategies, ported as plain PyTorch:
``layers.blocked_attention`` (online softmax over q and kv blocks) and
``layers.split_kv_decode_attention`` (a partial softmax a cache split,
then the log-sum-exp combine), against ``repro``'s on the same inputs
made from a seed with numpy, at ``tests/test_kernels.py``'s shapes.

Limits are ``test_kernels.py``'s: 0.02 (absolute and relative) in bf16,
2e-5 in f32.  Blocks of 64 make ``Sq > block_q`` and ``Skv > block_kv``
at every shape but S 64, with padding where S is no multiple of 64 (96,
160); the default blocks (and S 64) take the ``Skv <= block_kv``
shortcut to ``naive_attention``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as j_layers  # noqa: E402

from repro_torch.models import layers as t_layers  # noqa: E402

TOL = {"bf16": 0.02, "f32": 2e-5}
J_DT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
T_DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _pair(rng, shape, dt):
    """The same draw in both packages (rounded to ``dt`` once)."""
    x = jnp.asarray(rng.normal(size=shape), jnp.float32).astype(J_DT[dt])
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(T_DT[dt])
    return x, t


def _close(t_out, j_out, dt):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (2, 128, 4, 2, 64, True, 0),
    (1, 256, 8, 2, 64, True, 64),
    (2, 96, 4, 4, 32, True, 0),        # non-block-multiple S: padding
    (1, 64, 4, 1, 128, False, 0),      # MQA, bidirectional
    (1, 160, 6, 2, 48, True, 32),      # odd head_dim, SWA, padding
])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("blocks", [64, 1024])
def test_blocked_attention_matches_repro(B, S, H, K, hd, causal, window, dt,
                                         blocks):
    rng = np.random.default_rng(S * 7 + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B, S, H, hd), dt),
                                    _pair(rng, (B, S, K, hd), dt),
                                    _pair(rng, (B, S, K, hd), dt))
    valid = rng.random(S) > 0.1
    valid[0] = True
    pos = np.arange(S, dtype=np.int32)
    for kv_valid in (None, valid):
        want = j_layers.blocked_attention(
            jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), causal, window,
            None if kv_valid is None else jnp.asarray(kv_valid),
            block_kv=blocks, block_q=blocks)
        got = t_layers.blocked_attention(
            tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos), causal,
            window, None if kv_valid is None else torch.from_numpy(kv_valid),
            block_kv=blocks, block_q=blocks)
        assert got.dtype == T_DT[dt] and got.shape == (B, S, H, hd)
        _close(got, want, dt)


@pytest.mark.parametrize("B,H,K,hd,W,window,fill", [
    (2, 8, 2, 64, 128, 0, 100),
    (1, 4, 4, 32, 256, 64, 256),
    (2, 4, 1, 128, 64, 0, 10),         # nearly-empty cache
    (1, 8, 8, 64, 96, 0, 96),          # MHA, non-multiple W
])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("n_splits", [4, 5])
def test_split_kv_decode_matches_repro(B, H, K, hd, W, window, fill, dt,
                                       n_splits):
    """``n_splits`` 4 divides every W here (splits), 5 none (one split)."""
    assert (W % n_splits == 0) == (n_splits == 4)
    rng = np.random.default_rng(W + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B, 1, H, hd), dt),
                                    _pair(rng, (B, W, K, hd), dt),
                                    _pair(rng, (B, W, K, hd), dt))
    cpos = np.where(np.arange(W) < fill, np.arange(W), -1).astype(np.int32)
    q_pos = np.asarray([fill - 1], np.int32)
    want = j_layers.split_kv_decode_attention(
        jq, jk, jv, jnp.asarray(cpos), jnp.asarray(q_pos), window, n_splits)
    got = t_layers.split_kv_decode_attention(
        tq, tk, tv, torch.from_numpy(cpos), torch.from_numpy(q_pos), window,
        n_splits)
    assert got.dtype == T_DT[dt] and got.shape == (B, 1, H, hd)
    _close(got, want, dt)
