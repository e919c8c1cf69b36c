"""The port's kernels against the JAX package's, on the CPU.

On the CPU every wrapper runs its plain PyTorch version (`repro_torch.kernels.
ref`); these tests hold those to the JAX package's oracles
(`repro.kernels.ref`) and to its Pallas kernels run by the Pallas
interpreter, with sweeps like tests/test_kernels.py.  Inputs are numpy draws
from fixed seeds, rounded to bf16 the same way on both sides.

Tolerances: quant and dequant exact (the arithmetic is the same IEEE f32
division, rounding half to even, and one product); rmsnorm f32 1e-6, bf16 one
bf16 ulp (one rounding of the f32 result, sums in a different order);
attention f32 2e-5 and bf16 2e-2 (the tolerances of tests/test_kernels.py:
sums over keys in a different order, bf16 output rounding).

The CUDA kernels themselves run only on the card: see
tests/test_torch_cuda.py.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    _SWEEP = settings(max_examples=6, deadline=None, derandomize=True)
except ImportError:  # deterministic fallback engine of tests/conftest.py
    from conftest import given, st  # noqa: F401

    def _SWEEP(f):
        return f

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, quant as pt_quant, ref, rmsnorm as pt_rn

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(seed: int, shape, dtype: str, scale: float = 1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DT[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@_SWEEP
@given(
    B=st.sampled_from([1, 2]),
    S=st.sampled_from([16, 33, 64]),
    kh=st.sampled_from([(4, 4), (4, 2), (6, 3), (8, 1)]),
    D=st.sampled_from([16, 32, 64]),
    causal=st.booleans(),
    window=st.sampled_from([None, 24]),
    dtype=st.sampled_from(["float32", "bfloat16"]),
)
def test_flash_plain_matches_reference(B, S, kh, D, causal, window, dtype):
    H, KH = kh
    jq, q = _pair(0, (B, S, H, D), dtype)
    jk, k = _pair(1, (B, S, KH, D), dtype)
    jv, v = _pair(2, (B, S, KH, D), dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window),
                 jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      impl="pallas_interpret", block_q=32,
                                      block_k=32)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,sk,window", [(1, 77, None), (16, 48, None),
                                          (16, 48, 8), (5, 40, 3)])
def test_flash_suffix_queries_align_to_the_end(sq, sk, window):
    """Sq < Sk: query i sits at key position i + Sk - Sq (decode suffix)."""
    jq, q = _pair(6, (2, sq, 4, 32), "float32")
    jk, k = _pair(7, (2, sk, 2, 32), "float32")
    jv, v = _pair(8, (2, sk, 2, 32), "float32")
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=True, window=window),
                 jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                      impl="pallas_interpret", block_q=16,
                                      block_k=32)):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_flash_fully_masked_rows_are_zero():
    """Causal Sq > Sk: the first Sq - Sk queries see no key.  The port gives
    0 there, as the JAX package's CPU path (kvscan) does; the other rows
    match it."""
    jq, q = _pair(9, (1, 8, 2, 16), "float32")
    jk, k = _pair(10, (1, 4, 2, 16), "float32")
    jv, v = _pair(11, (1, 4, 2, 16), "float32")
    got = _np(ops.flash_attention(q, k, v, causal=True))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, :4], 0.0)
    want = _np(jops.flash_attention(jq, jk, jv, causal=True, impl="kvscan"))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_flash_rejects_bad_head_grouping():
    q = torch.zeros((1, 4, 5, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ops.flash_attention(q, k, k)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@_SWEEP
@given(R=st.integers(1, 70), d=st.sampled_from([32, 128, 384]),
       dtype=st.sampled_from(["float32", "bfloat16"]),
       wdtype=st.sampled_from(["float32", "bfloat16"]))
def test_rmsnorm_plain_matches_reference(R, d, dtype, wdtype):
    jx, x = _pair(12, (R, d), dtype)
    jw, w = _pair(13, (d,), wdtype)
    got = _np(ops.rmsnorm(x, w))
    assert ops.rmsnorm(x, w).dtype == x.dtype
    for want in (jref.rmsnorm_ref(jx, jw),
                 jops.rmsnorm(jx, jw, impl="pallas_interpret")):
        want = _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        else:
            mag = np.maximum(np.abs(want), 2.0 ** -126)
            ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
            assert (np.abs(got - want) <= ulp).all()


def test_rmsnorm_keeps_leading_dims():
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((2, 3, 64))
                         .astype(np.float32))
    w = torch.ones(64)
    y = ops.rmsnorm(x, w)
    assert y.shape == x.shape
    torch.testing.assert_close(y.reshape(6, 64), pt_rn.rmsnorm_rows(x.reshape(6, 64), w))


# ---------------------------------------------------------------------------
# int8 quant / dequant
# ---------------------------------------------------------------------------

@_SWEEP
@given(R=st.integers(1, 40), nb=st.integers(1, 4),
       block=st.sampled_from([256, 100, 7, 1]),
       scale=st.floats(1e-3, 1e3))
def test_quant_dequant_exact_against_reference(R, nb, block, scale):
    n = nb * block
    jx, x = _pair(15, (R, n), "float32", scale)
    x[0, :block] = 0.0                     # one all-zero block: scale 1, q 0
    jx = jx.at[0, :block].set(0.0)
    q, s = ops.quant_int8(x, block=block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert float(s[0, 0]) == 1.0 and not q[0, :block].any()
    qr, sr = jref.quant_int8_ref(jx, block)
    np.testing.assert_array_equal(_np(q), np.asarray(qr))
    np.testing.assert_array_equal(_np(s), np.asarray(sr))
    if block == 256:    # the Pallas kernel's block is a BlockSpec lane width
        # q exact; the interpreter's scales may sit one f32 ulp off the
        # oracle's, as tests/test_kernels.py allows (rtol 1e-6)
        qk, sk = jops.quant_int8(jx, block=block, impl="pallas_interpret")
        np.testing.assert_array_equal(_np(q), np.asarray(qk))
        np.testing.assert_allclose(_np(s), np.asarray(sk), rtol=1e-6)
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = DT[dtype]
        got = ops.dequant_int8(q, s, block=block, dtype=tdt)
        assert got.dtype == tdt
        want = jref.dequant_int8_ref(jnp.asarray(_np(q)), jnp.asarray(_np(s)),
                                     block, jdt)
        np.testing.assert_array_equal(_np(got), _np(want))


def test_quant_round_half_to_even_and_clip():
    # amax 127 -> scale 1: x / scale is x itself, so ties round to even
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 3.49]])
    q, s = ops.quant_int8(x, block=8)
    assert s.tolist() == [[1.0]]
    assert q.tolist() == [[0, 2, 2, 0, -2, 127, -127, 3]]


@pytest.mark.parametrize("shape,block", [((3, 255), 256), ((2, 10), 4), ((), 256)])
def test_quant_ragged_trailing_dim_raises(shape, block):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match="block"):
        ops.quant_int8(x, block=block)
    if len(shape) == 2:
        with pytest.raises(ValueError, match="multiple of block"):
            pt_quant.quant_int8_2d(x, block=block)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_impl_cuda_on_cpu_tensors_raises():
    x = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.rmsnorm(x, torch.ones(256), impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.quant_int8(x, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.dequant_int8(x.to(torch.int8), torch.ones((2, 1)), impl="cuda")
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.rmsnorm(x, torch.ones(256), impl="pallas")


def test_auto_on_cpu_is_the_plain_version_and_counts_no_launch():
    ops.reset_launch_counts()
    jq, q = _pair(16, (1, 8, 2, 32), "bfloat16")
    torch.testing.assert_close(ops.flash_attention(q, q, q),
                               ref.flash_attention_ref(q, q, q), rtol=0, atol=0)
    x = q.reshape(8, 64)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(64)),
                               ref.rmsnorm_ref(x, torch.ones(64)), rtol=0, atol=0)
    assert ops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                                   "quant_int8": 0, "dequant_int8": 0}
