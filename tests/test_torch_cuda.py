"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips, inside the test, when
PyTorch sees no CUDA device.  The file imports torch only (no jax), so it
also runs on a machine without the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: quant and dequant exact; rmsnorm one bf16 ulp; attention 2e-2
(bf16 output, P rounded to bf16 before P.V, sums over keys in another
order); the attention backward, each gradient elementwise within 2 % of its
largest entry plus 2 % of the entry (bf16 output, P and dS rounded to bf16
before the products that take them, delta from the bf16 output, sums over
keys and queries in another order than autograd's).
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


@pytest.mark.parametrize("b,sq,sk,h,kh,d,window,amp", [
    (2, 97, 97, 6, 2, 128, None, 1.0), (2, 33, 80, 6, 2, 64, 16, 1.0),
    (2, 8, 4, 4, 4, 32, None, 1.0), (2, 1, 77, 24, 8, 128, None, 1.0),
    (2, 130, 130, 8, 1, 64, 1, 1.0),
    (1, 1024, 1024, 24, 8, 128, None, 1.0),             # full width, 64-row tiles
    (1, 63, 63, 6, 2, 128, None, 1.0), (1, 65, 65, 6, 2, 128, None, 1.0),   # tile -+ 1
    (1, 127, 127, 6, 2, 128, None, 1.0), (1, 129, 129, 6, 2, 128, None, 1.0),
    (1, 1, 2048, 24, 8, 128, None, 1.0),                # one query, 32 key tiles
    (1, 200, 200, 4, 2, 64, 100, 1.0),                  # window ends mid-tile
    (1, 150, 300, 4, 1, 32, 70, 1.0),                   # head dim 32, suffix + window
    (3, 96, 96, 48, 16, 64, None, 1.0),                 # B*H = 144 above 132 SMs
    (1, 256, 256, 8, 2, 128, None, 30.0),               # huge scores: no NaN or Inf
    (1, 100, 30, 4, 2, 64, None, 1.0),                  # Sq > Sk: 70 rows see no key
    (1, 200, 200, 8, 2, 120, None, 1.0),                # head dim 120 (h2o-danube-3-4b)
    (1, 300, 300, 4, 1, 120, 100, 1.0),                 # head dim 120, window
    (1, 40, 90, 4, 2, 120, None, 1.0)])                 # head dim 120, query suffix
def test_flash_matches_plain(cuda, b, sq, sk, h, kh, d, window, amp):
    q = _rnd(cuda, b, sq, h, d, seed=1, scale=amp)
    k = _rnd(cuda, b, sk, kh, d, seed=2, scale=amp)
    v = _rnd(cuda, b, sk, kh, d, seed=3)
    got = fa.flash_attention_bshd(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    if sq > sk:                      # queries with no valid key give 0
        assert not got[:, :sq - sk].any()


def _misaligned(dev, rows, d, dtype):
    """(rows, d) whose data starts one element past a 16-byte boundary."""
    flat = _rnd(dev, rows * d + 1, dtype=dtype)
    return flat[1:].view(rows, d)


@pytest.mark.parametrize("rows,d,dtype,wdtype,layout", [
    (37, 3072, torch.bfloat16, torch.bfloat16, "row"),
    (8, 3072, torch.bfloat16, torch.float32, "row"),
    (5, 100, torch.float32, torch.float32, "twopass"),
    (3, 64, torch.float32, torch.bfloat16, "twopass"),
    (5, 3072, torch.float32, torch.bfloat16, "row"), (5, 3072, torch.float32, torch.float32, "row"),
    (9, 1024, torch.bfloat16, torch.bfloat16, "row"), (9, 1536, torch.bfloat16, torch.float32, "row"),
    *[(r, d, torch.bfloat16, torch.bfloat16, "row")
      for r in (1, 8, 1024) for d in (3072, 5120, 6144)],
    (8, 6144, torch.bfloat16, torch.float32, "row"),
    (4, 6144, torch.float32, torch.float32, "twopass"),      # above the registers
    (8, 3071, torch.bfloat16, torch.bfloat16, "twopass"),    # odd d
    (8, 3072, torch.bfloat16, torch.bfloat16, "misaligned")])
def test_rmsnorm_matches_plain(cuda, rows, d, dtype, wdtype, layout):
    if layout == "misaligned":
        x = _misaligned(cuda, rows, d, dtype)
    else:
        x = _rnd(cuda, rows, d, dtype=dtype)
    w = _rnd(cuda, d, dtype=wdtype, seed=4)
    want_path = rmsnorm.PATH_ROW if layout == "row" else (
        rmsnorm.PATH_VECTOR if d % (16 // x.element_size()) == 0 and layout != "misaligned"
        else rmsnorm.PATH_SCALAR)
    y = torch.empty_like(x)
    assert rmsnorm.row_path(d, x.element_size(), x.data_ptr(), y.data_ptr(),
                            w.data_ptr()) == want_path
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


QUANT_CASES = ("kv_chunk", "zero_block", "at_127_scale", "ties", "partial_thread_block",
               "misaligned", "block_100", "block_48", "block_7", "block_1")


def _quant_input(dev, case, dtype):
    """(x, block) of one quant case: 3 blocks a row unless stated."""
    block = {"block_100": 100, "block_48": 48, "block_7": 7, "block_1": 1}.get(case, 256)
    if case == "kv_chunk":               # one 8 MiB bf16 chunk of the KV ship
        return _rnd(dev, 1, 4 * 1024 * 8 * 128, dtype=dtype, scale=3.0, seed=5), block
    rows = 13 if case == "partial_thread_block" else 4   # 39 blocks: 8 warps a block
    n = 3 * block
    if case == "misaligned":             # one element past a 16-byte boundary
        return _rnd(dev, rows * n + 1, dtype=dtype, scale=5.0, seed=5)[1:].view(rows, n), block
    x = _rnd(dev, rows, n, dtype=torch.float32, scale=5.0, seed=5)
    if case == "zero_block":
        x[1, block:2 * block] = 0.0
    elif case == "at_127_scale":         # every block reaches +-127 * 2^e exactly
        g = torch.Generator(device=dev).manual_seed(6)
        k = torch.randint(-127, 128, (rows, 3, block), generator=g, device=dev).float()
        k[:, :, 0], k[:, :, 1] = 127.0, -127.0
        e = torch.arange(-6, -6 + rows * 3, device=dev, dtype=torch.float32)
        x = (k * torch.exp2(e).reshape(rows, 3, 1)).reshape(rows, n)
    elif case == "ties":                 # scale 1: every k + 0.5 is a tie
        row = torch.cat([torch.tensor([127.0, -127.0], device=dev),
                         torch.arange(-127, 127, device=dev).float() + 0.5])
        x = row.repeat(rows, 3)
    return x.to(dtype), block


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_paths_exact(cuda, case, dtype):
    """The warp path (block 256, aligned) and the block path (other blocks,
    or a misaligned view) each equal the plain version bit for bit."""
    x, block = _quant_input(cuda, case, dtype)
    want_path = (quant.PATH_VECTOR if block == 256 and case != "misaligned"
                 else quant.PATH_BLOCK)
    assert quant.quant_path(block, x.data_ptr()) == want_path
    q, s = quant.quant_int8_2d(x, block=block)
    qr, sr = ref.quant_int8_ref(x, block)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    if case == "zero_block":
        assert float(s[1, 1]) == 1.0 and not q[1, block:2 * block].any()
    if case == "at_127_scale":
        assert bool((q[:, 0::block] == 127).all() and (q[:, 1::block] == -127).all())
    if case == "ties":                   # half to even: -126.5 -> -126, 0.5 -> 0, 1.5 -> 2
        assert q[0, 2:8].tolist() == [-126, -126, -124, -124, -122, -122]
        assert q[0, 129:131].tolist() == [0, 2]


DEQUANT_CASES = ("kv_chunk", "partial_thread_block", "block_48", "misaligned",
                 "block_100", "block_7", "block_1")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", DEQUANT_CASES)
def test_dequant_paths_exact(cuda, case, dtype):
    """The vector path (block a multiple of 16, q aligned; block 48 takes the
    division, 256 the shift) and the block path, to bf16 and f32."""
    x, block = _quant_input(cuda, "block_48" if case == "misaligned" else case,
                            torch.float32)
    q, s = ref.quant_int8_ref(x, block)
    if case == "misaligned":             # q one byte past a 16-byte boundary
        flat = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
        flat[1:].copy_(q.reshape(-1))
        q = flat[1:].view(q.shape)
    want_path = (quant.PATH_VECTOR if block % 16 == 0 and case != "misaligned"
                 else quant.PATH_BLOCK)
    assert quant.dequant_path(block, q.data_ptr()) == want_path
    got = quant.dequant_int8_2d(q, s, block=block, dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, ref.dequant_int8_ref(q, s, block, dtype))


def test_quant_rejects_other_input_types(cuda):
    for dt in (torch.float16, torch.int32):
        with pytest.raises(TypeError, match="quant_int8_2d"):
            quant.quant_int8_2d(torch.zeros((2, 256), dtype=dt, device=cuda))
    with pytest.raises(TypeError, match="dequant_int8_2d"):
        quant.dequant_int8_2d(torch.zeros((2, 256), dtype=torch.int8, device=cuda),
                              torch.ones((2, 1), device=cuda), dtype=torch.float16)


def test_int8_kv_ship_codec_keeps_bf16_and_launches_once_each(cuda):
    """kvship's int8 codec hands a bf16 chunk to the kernels as it is: one
    quant and one dequant launch, bf16 out, equal to the plain versions."""
    from repro_torch.core import kvship
    arr = _rnd(cuda, 4, 100, 8, 128, scale=3.0, seed=7)
    ops.reset_launch_counts()
    got, wire = kvship._encode_decode(arr, "int8")
    torch.cuda.synchronize()
    assert ops.launch_counts()["quant_int8"] == 1
    assert ops.launch_counts()["dequant_int8"] == 1
    q, s = ref.quant_int8_ref(arr.reshape(-1), 256)
    want = ref.dequant_int8_ref(q, s, 256, torch.bfloat16).reshape(arr.shape)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert wire == arr.numel() + 4 * (arr.numel() // 256)


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
    assert ops.launch_counts() == {"flash_attention": 1, "flash_attention_bwd": 0,
                                   "rmsnorm": 1, "quant_int8": 1,
                                   "dequant_int8": 1}
    with pytest.raises(TypeError):
        fa.flash_attention_bshd(q.float(), q.float(), q.float())


def _grads_plain(q, k, v, do, causal, window):
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    ref.flash_attention_ref(qs, ks, vs, causal=causal, window=window).backward(do)
    return qs.grad, ks.grad, vs.grad


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window", [
    (1, 128, 128, 4, 4, 32, True, None),                # group 1, head dim 32
    (2, 97, 97, 6, 2, 64, True, None),                  # group 3, ragged tiles
    (1, 200, 200, 6, 2, 120, True, None),               # head dim 120
    (1, 130, 130, 3, 1, 128, True, 48),                 # group 3, window
    (1, 256, 256, 4, 4, 64, True, 64),                  # group 1, window on tile edges
    (1, 100, 30, 6, 2, 64, True, None),                 # Sq > Sk: 70 rows see no key
    (1, 33, 80, 3, 1, 120, True, 16),                   # query suffix + window, D 120
    (1, 77, 150, 2, 2, 128, True, None),                # query suffix, D 128
    (1, 96, 96, 4, 2, 64, False, None),                 # not causal
    (1, 1024, 1024, 16, 16, 64, True, None),            # qwen1.5-0.5b's heads
    (1, 333, 333, 6, 2, 128, True, None),               # D 128, group 3, ragged last tile
    (1, 100, 160, 4, 2, 32, False, None)])              # not causal, head dim 32, Sq < Sk
def test_flash_bwd_matches_plain(cuda, b, sq, sk, h, kh, d, causal, window):
    q = _rnd(cuda, b, sq, h, d, seed=1)
    k = _rnd(cuda, b, sk, kh, d, seed=2)
    v = _rnd(cuda, b, sk, kh, d, seed=3)
    # dO as the model hands it over: a non-contiguous view
    do = _rnd(cuda, b, h, sq, d, seed=4).transpose(1, 2)
    o, lse = fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    got = fa.flash_attention_bwd_bshd(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    want = _grads_plain(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(g).all()), name
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2 * top,
                                   rtol=2e-2, msg=name)
    if sq > sk:                      # queries with no valid key: zero gradient
        assert not got[0][:, :sq - sk].any()


@pytest.mark.parametrize("h,kh,d,window", [(4, 4, 64, None), (6, 2, 128, 100),
                                          (8, 2, 120, None)])
def test_flash_bwd_is_deterministic(cuda, h, kh, d, window):
    """dK and dV are summed over the GQA group in registers in a fixed order
    and every output element is written once: two calls give the same bits."""
    q = _rnd(cuda, 1, 333, h, d, seed=1)
    k = _rnd(cuda, 1, 333, kh, d, seed=2)
    v = _rnd(cuda, 1, 333, kh, d, seed=3)
    do = _rnd(cuda, 1, 333, h, d, seed=4)
    o, lse = fa.flash_attention_bshd(q, k, v, window=window, return_lse=True)
    first = fa.flash_attention_bwd_bshd(q, k, v, o, lse, do, window=window)
    second = fa.flash_attention_bwd_bshd(q, k, v, o, lse, do, window=window)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


def test_flash_function_counts_the_backward_launch(cuda):
    q = _rnd(cuda, 1, 64, 4, 64, seed=5).requires_grad_(True)
    k = _rnd(cuda, 1, 64, 2, 64, seed=6).requires_grad_(True)
    v = _rnd(cuda, 1, 64, 2, 64, seed=7).requires_grad_(True)
    ops.reset_launch_counts()
    o = ops.flash_attention(q, k, v)
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    want = _grads_plain(q, k, v, (2 * o.detach().float()).to(torch.bfloat16), True, None)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2 * top, rtol=2e-2)
    ops.reset_launch_counts()
    with torch.no_grad():                # no gradient wanted: forward only
        ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


def test_rmsnorm_function_keeps_dtypes_on_the_card(cuda):
    x = _rnd(cuda, 8, 1024, seed=8).requires_grad_(True)
    w = _rnd(cuda, 1024, seed=9, dtype=torch.float32).requires_grad_(True)
    ops.reset_launch_counts()
    ops.rmsnorm(x, w).float().sum().backward()
    assert ops.launch_counts()["rmsnorm"] == 1
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    dx, dw = ops.rmsnorm_bwd(x.detach().cpu(), w.detach().cpu(),
                             torch.ones(8, 1024, dtype=torch.bfloat16), 1e-5)
    # the same f32 arithmetic, reduced in another order on the card
    torch.testing.assert_close(x.grad.cpu().float(), dx.float(), atol=1e-3, rtol=2 ** -7)
    torch.testing.assert_close(w.grad.cpu(), dw, atol=1e-3, rtol=1e-5)
