"""PyTorch port — flash attention (kernel K1) against the JAX reference:

* the plain version (what ``ops.flash_attention`` runs on a CPU tensor,
  and the yardstick the CUDA kernel is held against on the card) against
  JAX ``ops.flash_attention`` (the Pallas kernel in interpret mode) over
  ``tests/test_kernels_flash.py``'s sweep, at its tolerances (fp32 2e-5,
  bf16 2e-2), and the block-size invariance;
* gradients: torch autograd of ``ops.flash_attention`` (backward =
  autograd through ``chunked_attention``) against ``jax.grad`` through the
  reference's custom_vjp, fp32, 2e-5 (fp32 sums in another order),
  including windowed rows, rows padded past ``sq`` to the chunk size and
  fully masked rows (a negative offset), with every gradient finite;
* ``chunked_attention`` and ``layer_norm`` against the reference; the
  ``attention`` dispatch's flash branch taken exactly under the
  reference's condition;
* zamba2-7b's shared-block head dim 112 (MHA, not a multiple of 64): the
  plain version and the op's gradients against the Pallas kernel in
  interpret mode.

The CUDA kernel itself runs only on a card: its test carries the ``gpu``
marker and skips here (chip_smoke.py holds it against the plain version
at the training path's shapes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers

torch.set_num_threads(2)

# tests/test_kernels_flash.py's sweep
SWEEP = [
    # b, sq, sk, hq, hkv, hd, causal, window, off, dtype
    (1, 64, 64, 4, 2, 16, True, 0, 0, "float32"),
    (2, 33, 33, 4, 4, 32, True, 0, 0, "float32"),
    (1, 128, 128, 8, 2, 16, True, 24, 0, "float32"),
    (1, 16, 48, 4, 1, 16, True, 0, 32, "float32"),
    (2, 40, 40, 4, 2, 16, False, 0, 0, "bfloat16"),
    (1, 72, 72, 2, 2, 64, True, 0, 0, "bfloat16"),
    (1, 8, 8, 1, 1, 8, True, 0, 0, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference's tolerances
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, b, sq, sk, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_plain_matches_reference_kernel(case):
    b, sq, sk, hq, hkv, hd, causal, window, off, dt = SWEEP[case]
    arrs = _qkv(case, b, sq, sk, hq, hkv, hd)
    want = jops.flash_attention(
        *(jnp.asarray(a, JDT[dt]) for a in arrs), causal=causal,
        window=window, kv_offset=off, block_q=16, block_k=16)
    q, k, v = (torch.from_numpy(a).to(TDT[dt]) for a in arrs)
    launches = tfa.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window,
                               kv_offset=off, block_q=16, block_k=16)
    assert tfa.launches == launches  # a CPU tensor never reaches the kernel
    assert got.dtype == TDT[dt] and got.shape == q.shape
    assert _err(want.astype(jnp.float32), got.float()) < TOL[dt]


# zamba2-7b's shared attention block: MHA at head_dim 112 (a narrow
# stand-in for its 32 heads), causal, over a ragged 100-token sequence
HD112 = [(1, 100, 100, 4, 4, 112, True, 0, 0, dt)
         for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_hd112(dt):
    b, sq, sk, hq, hkv, hd, causal, window, off, _ = HD112[0]
    arrs = _qkv(112, b, sq, sk, hq, hkv, hd)
    want = jops.flash_attention(
        *(jnp.asarray(a, JDT[dt]) for a in arrs), causal=causal,
        block_q=32, block_k=32)
    q, k, v = (torch.from_numpy(a).to(TDT[dt]) for a in arrs)
    got = tops.flash_attention(q, k, v, causal=causal, block_q=32,
                               block_k=32)
    assert got.dtype == TDT[dt] and got.shape == q.shape
    assert _err(want.astype(jnp.float32), got.float()) < TOL[dt]
    if dt == "float32":  # the op's gradients, as test_gradients_match_...
        ct = np.random.default_rng(113).normal(size=arrs[0].shape).astype(
            np.float32)
        jg = jax.grad(lambda *x: jnp.sum(jops.flash_attention(
            *x, causal=causal, block_q=32, block_k=32) * ct),
            argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
        tops.flash_attention(q, k, v, causal=causal, block_q=32,
                             block_k=32).backward(torch.from_numpy(ct))
        for want_g, got_g in zip(jg, (q.grad, k.grad, v.grad)):
            assert _err(want_g, got_g) < 2e-5


def test_block_size_invariance():
    """Forward and backward agree across block sizes (the backward's
    chunking follows them: chunks of 128 and 256 over 300 positions)."""
    arrs = _qkv(9, 1, 300, 300, 4, 2, 16)
    g = np.random.default_rng(10).normal(size=arrs[0].shape).astype(
        np.float32)
    outs = []
    for bq, bk in [(16, 16), (256, 128), (128, 256), (512, 512)]:
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
        o = tops.flash_attention(q, k, v, causal=True, block_q=bq,
                                 block_k=bk)
        o.backward(torch.from_numpy(g))
        outs.append([o.detach(), q.grad, k.grad, v.grad])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


GRAD_CASES = [
    # b, sq, sk, hq, hkv, hd, causal, window, off, block
    (1, 64, 64, 4, 2, 16, True, 0, 0, 16),      # causal GQA
    (1, 200, 200, 4, 2, 16, True, 24, 0, 16),   # window; 200 pads to 256
    (2, 33, 33, 4, 4, 32, True, 0, 0, 16),      # ragged sq, MHA
    (1, 16, 48, 4, 1, 16, True, 0, 32, 16),     # kv_offset
    (1, 40, 40, 4, 2, 16, True, 8, -8, 16),     # rows 0-7 fully masked
    (2, 40, 40, 4, 2, 16, False, 0, 0, 16),     # non-causal
]


@pytest.mark.parametrize("case", range(len(GRAD_CASES)))
def test_gradients_match_reference(case):
    b, sq, sk, hq, hkv, hd, causal, window, off, blk = GRAD_CASES[case]
    arrs = _qkv(20 + case, b, sq, sk, hq, hkv, hd)
    ct = np.random.default_rng(40 + case).normal(
        size=arrs[0].shape).astype(np.float32)

    def jloss(q, k, v):
        o = jops.flash_attention(q, k, v, causal=causal, window=window,
                                 kv_offset=off, block_q=blk, block_k=blk)
        return jnp.sum(o * ct)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o = tops.flash_attention(q, k, v, causal=causal, window=window,
                             kv_offset=off, block_q=blk, block_k=blk)
    o.backward(torch.from_numpy(ct))
    for want, got in zip(jg, (q.grad, k.grad, v.grad)):
        assert torch.isfinite(got).all()
        assert _err(want, got) < 2e-5
    if off < 0:  # fully masked rows: zero output, zero gradient
        assert not o[:, :-off].detach().any()
        assert not q.grad[:, :-off].any()


@pytest.mark.parametrize("window,kv_len", [(0, None), (5, None),
                                           (0, [30, 17])])
def test_chunked_attention_and_grad_match_reference(window, kv_len):
    """Multi-chunk online softmax (chunks 8 x 16 over 30 positions, so
    the last q chunk is padded past sq) with gradients, against the
    reference's chunked_attention under jax.grad."""
    arrs = _qkv(3, 2, 30, 30, 4, 2, 16)
    ct = np.random.default_rng(4).normal(size=arrs[0].shape).astype(
        np.float32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)

    def jloss(q, k, v):
        o = jlayers.chunked_attention(
            q, k, v, causal=True, window=window,
            kv_len=None if kl is None else jnp.asarray(kl), q_chunk=8,
            kv_chunk=16)
        return jnp.sum(o * ct), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in arrs))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o = tlayers.chunked_attention(
        q, k, v, causal=True, window=window,
        kv_len=None if kl is None else torch.from_numpy(kl), q_chunk=8,
        kv_chunk=16)
    o.backward(torch.from_numpy(ct))
    assert _err(jo, o.detach()) < 2e-5
    for want, got in zip(jg, (q.grad, k.grad, v.grad)):
        assert torch.isfinite(got).all()
        assert _err(want, got) < 2e-5


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(5)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 3, 16), (16,), (16,)))
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tlayers.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    assert _err(want, got) < 2e-6


def test_attention_dispatch_takes_flash_branch_as_reference(monkeypatch):
    """The flash branch runs for sq > 1 with no kv_len and a scalar offset,
    only when opts ask for it — the reference's condition."""
    calls = []
    real = tops.flash_attention
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    arrs = [torch.from_numpy(a) for a in _qkv(6, 2, 8, 8, 4, 2, 16)]
    on = tlayers.ModelOptions(use_flash_kernel=True)
    off = tlayers.ModelOptions()
    tlayers.attention(*arrs, causal=True, opts=on)
    assert calls == [1]
    tlayers.attention(*arrs, causal=True, opts=off)
    tlayers.attention(arrs[0][:, :1], *arrs[1:], causal=True, opts=on,
                      kv_offset=torch.tensor([7, 7]), kv_len=torch.tensor(
                          [8, 8]))
    tlayers.attention(*arrs, causal=True, opts=on,
                      kv_offset=torch.tensor([0, 1]))
    assert calls == [1]


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_kernel(q, k, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# card-only cases beside SWEEP's: the bf16 tensor-core variant at sq not a
# multiple of its 64-row tile, head_dim 128 and 64, windows and offsets
CARD_SWEEP = SWEEP + [
    (1, 100, 100, 32, 2, 128, True, 0, 0, "bfloat16"),
    (2, 72, 136, 8, 2, 64, True, 0, 64, "bfloat16"),
    (1, 130, 130, 4, 1, 128, True, 50, 0, "bfloat16"),
    (1, 130, 130, 4, 1, 128, True, 50, 0, "float32"),
    (2, 200, 200, 4, 2, 128, False, 0, 0, "bfloat16"),
] + HD112


@pytest.mark.gpu
def test_kernel_refuses_head_dims_it_was_not_built_for(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(8, 1, 16, 16, 2, 2, 96))
    assert 96 not in tfa.HEAD_DIMS
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_kernel(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [i for i, c in enumerate(CARD_SWEEP)
                                  if c[5] in tfa.HEAD_DIMS])
def test_kernel_vs_plain_on_card(cuda_device, case):
    b, sq, sk, hq, hkv, hd, causal, window, off, dt = CARD_SWEEP[case]
    q, k, v = (torch.from_numpy(a).to(cuda_device, TDT[dt])
               for a in _qkv(case, b, sq, sk, hq, hkv, hd))
    got = tfa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                     kv_offset=off)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_offset=off)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < TOL[dt]


def test_wrappers_refuse_inputs_split_across_devices():
    """Every input of a launch shares one device: the kernel's wrapper and
    the op refuse a split (here a CPU q beside a meta k; on cards, q on
    one card beside k on another)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="split across devices"):
        tfa.flash_attention_kernel(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="split across devices"):
        tops.flash_attention(q, k, v.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_kernel_launches_on_its_tensors_device(dt):
    """A launch on cuda:1 while cuda:0 is current runs on cuda:1 (its
    context, its stream) and agrees with the plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda:1")
    q, k, v = (torch.from_numpy(a).to(dev, TDT[dt])
               for a in _qkv(10, 1, 256, 256, 32, 2, 128))
    with torch.cuda.device(0):
        got = tfa.flash_attention_kernel(q, k, v)
        want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize(dev)
    assert got.device == dev
    assert float((got.float() - want.float()).abs().max()) < TOL[dt]
