"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips, inside the test, when
PyTorch sees no CUDA device.  The file imports torch only (no jax), so it
also runs on a machine without the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: quant and dequant exact; rmsnorm one bf16 ulp; attention 2e-2
(bf16 output, sums over keys in another order).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, quant, ref, rmsnorm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on an NVIDIA card "
                    "(there: python3 chip_smoke.py, or this file)")
    return torch.device("cuda")


def _rnd(dev, *shape, dtype=torch.bfloat16, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("sq,sk,h,kh,d,window", [
    (97, 97, 6, 2, 128, None), (33, 80, 6, 2, 64, 16), (8, 4, 4, 4, 32, None),
    (1, 77, 24, 8, 128, None), (130, 130, 8, 1, 64, 1)])
def test_flash_matches_plain(cuda, sq, sk, h, kh, d, window):
    q = _rnd(cuda, 2, sq, h, d, seed=1)
    k = _rnd(cuda, 2, sk, kh, d, seed=2)
    v = _rnd(cuda, 2, sk, kh, d, seed=3)
    got = fa.flash_attention_bshd(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    if sq > sk:                      # queries with no valid key give 0
        assert not got[:, :sq - sk].any()


@pytest.mark.parametrize("rows,d,dtype,wdtype", [
    (37, 3072, torch.bfloat16, torch.bfloat16), (8, 3072, torch.bfloat16, torch.float32),
    (5, 100, torch.float32, torch.float32), (3, 64, torch.float32, torch.bfloat16)])
def test_rmsnorm_matches_plain(cuda, rows, d, dtype, wdtype):
    x, w = _rnd(cuda, rows, d, dtype=dtype), _rnd(cuda, d, dtype=wdtype, seed=4)
    got, want = rmsnorm.rmsnorm_rows(x, w).float(), ref.rmsnorm_ref(x, w).float()
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - (7 if dtype == torch.bfloat16 else 20))
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("rows,n,block", [(1, 4 * 1024 * 8 * 128, 256), (3, 700, 100),
                                          (2, 96, 1), (4, 768, 256)])
def test_quant_dequant_exact(cuda, rows, n, block):
    x = _rnd(cuda, rows, n, dtype=torch.float32, scale=5.0)
    x[0, :block] = 0.0
    q, s = quant.quant_int8_2d(x, block=block)
    qr, sr = ref.quant_int8_ref(x, block)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(quant.dequant_int8_2d(q, s, block=block, dtype=dt),
                           ref.dequant_int8_ref(q, s, block, dt))


def test_dispatch_launches_the_kernels_and_counts(cuda):
    ops.reset_launch_counts()
    x = _rnd(cuda, 4, 256)
    ops.rmsnorm(x, torch.ones(256, device=cuda, dtype=torch.bfloat16))
    qq, ss = ops.quant_int8(x.float(), impl="cuda")
    ops.dequant_int8(qq, ss)
    q = _rnd(cuda, 1, 8, 2, 32)
    ops.flash_attention(q, q, q)
    ops.flash_attention(q, q, q, impl="plain")          # not a launch
    ops.rmsnorm(x.cpu(), torch.ones(256))                # CPU: plain, not a launch
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_attention": 1, "rmsnorm": 1,
                                   "quant_int8": 1, "dequant_int8": 1}
    with pytest.raises(TypeError):
        fa.flash_attention_bshd(q.float(), q.float(), q.float())
