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

* the backward: on a CPU tensor ``ops.flash_attention``'s gradients are
  autograd through ``chunked_attention``, bit for bit; the backward
  kernels' wrapper refuses what the kernels do not take; no device kernel
  of its source carries K1's forward's name (the benchmark counts K1's
  forward records by it).

The CUDA kernels themselves run only on a card: their tests carry the
``gpu`` marker and skip here (chip_smoke.py holds them against the plain
versions at the training path's shapes)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.analysis import costs
from repro_torch.kernels import attention_bwd as tbwd
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.obs import tracer as tobs
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


# ---------------------------------------------------------------------------
# the backward kernels (kernels/attention_bwd.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(GRAD_CASES)))
def test_cpu_gradients_are_chunked_autograd_bit_for_bit(case):
    """On a CPU tensor the op's backward is autograd through
    ``chunked_attention`` at ``max(block, 128)``-sized chunks, exactly."""
    b, sq, sk, hq, hkv, hd, causal, window, off, blk = GRAD_CASES[case]
    arrs = _qkv(60 + case, b, sq, sk, hq, hkv, hd)
    ct = torch.from_numpy(np.random.default_rng(80 + case).normal(
        size=arrs[0].shape).astype(np.float32))
    kw = dict(causal=causal, window=window, kv_offset=off)
    launches = tbwd.launches
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    tops.flash_attention(q, k, v, block_q=blk, block_k=blk,
                         **kw).backward(ct)
    assert tbwd.launches == launches  # a CPU tensor never reaches it
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tlayers.chunked_attention(*leaves, q_chunk=128, kv_chunk=128,
                              **kw).backward(ct)
    for got, want in zip((q.grad, k.grad, v.grad), leaves):
        assert torch.equal(got, want.grad)


def _bwd_args(seed, b=1, sq=16, sk=16, hq=4, hkv=2, hd=16):
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed, b, sq, sk, hq, hkv,
                                                  hd))
    return q, k, v, torch.zeros_like(q), torch.ones_like(q)


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_backward_wrapper_refuses_cpu_and_meta_tensors(where):
    args = [t.to(where) for t in _bwd_args(11)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tbwd.attention_bwd_kernel(*args)


@pytest.mark.parametrize("which", range(5))
def test_backward_wrapper_refuses_dtype_mismatches(which):
    args = list(_bwd_args(12))
    args[which] = args[which].to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        tbwd.attention_bwd_kernel(*args)



@pytest.mark.parametrize("empty", ["b", "sq", "sk", "none"])
def test_backward_wrapper_counts_only_calls_that_launch(monkeypatch, empty):
    """``launches``, its dtype split, the step tracer's ``k1_backward`` and
    the cost record count a call once its kernels launched; an empty input
    launches nothing, counts nothing and gets zero gradients. (The card is
    stood in for: the device check passes the CPU tensors and the launch
    records its call.)"""
    b, sq, sk = (0 if empty == n else 3 for n in ("b", "sq", "sk"))
    q, k, v = (torch.from_numpy(a)
               for a in _qkv(16, max(b, 1), max(sq, 1), max(sk, 1), 4, 2, 16))
    q, k, v = q[:b, :sq], k[:b, :sk], v[:b, :sk]
    args = (q, k, v, torch.ones_like(q), torch.ones_like(q))
    ran, recorded = [], []
    monkeypatch.setattr(tbwd.kbuild, "launch_device",
                        lambda *a, **t: q.device)
    monkeypatch.setattr(tbwd, "_launch", lambda *a: ran.append(a))
    monkeypatch.setattr(tbwd.costs, "record_launch",
                        lambda *a: recorded.append(a[0]))
    monkeypatch.setattr(tbwd, "launches", 5)
    monkeypatch.setattr(tbwd, "variant_launches", {"bf16": 0, "fp32": 0})
    tr = tobs.Tracer()
    with tobs.using(tr), costs.count():
        dq, dk, dv = tbwd.attention_bwd_kernel(*args)
    n = int(empty == "none")
    assert len(ran) == n and recorded == ["attention_bwd"] * n
    assert tbwd.launches == 5 + n
    assert tbwd.variant_launches == {"bf16": 0, "fp32": n}
    assert sum(tr.counters.get("k1_backward", {}).values()) == n
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    if not n:
        assert not (dq.any() or dk.any() or dv.any())


def test_backward_build_starts_once(monkeypatch):
    """The op's first CUDA forward starts the backward's build, once; the
    first backward waits for it."""
    started = []
    monkeypatch.setattr(tbwd, "_prebuilt", False)
    monkeypatch.setattr(tbwd, "_prebuild", None)
    monkeypatch.setattr(tbwd.kbuild, "start",
                        lambda source: started.append(source))
    tbwd.prebuild()
    tbwd.prebuild()
    assert started == [tbwd.SOURCE]

@pytest.mark.parametrize("hd", [8, 96])
def test_backward_wrapper_refuses_head_dims_it_was_not_built_for(hd):
    assert hd not in tfa.HEAD_DIMS
    with pytest.raises(ValueError, match="head_dim"):
        tbwd.attention_bwd_kernel(*_bwd_args(13, hd=hd))


def test_backward_wrappers_refuse_inputs_split_across_devices():
    """The kernels' wrapper and the op's backward refuse a split (a CPU
    dout beside meta q, k, v, out; on cards, one card beside another)."""
    q, k, v, out, dout = _bwd_args(14)
    meta = [t.to("meta") for t in (q, k, v, out)]
    with pytest.raises(ValueError, match="split across devices"):
        tbwd.attention_bwd_kernel(*meta, dout)

    class Ctx:  # what autograd hands the backward: saved tensors and args
        saved_tensors = tuple(meta)
        args = (True, 0, 0, 512, 512)

    with pytest.raises(ValueError, match="split across devices"):
        tops._FlashAttention.backward(Ctx, dout)


def test_backward_source_names_no_kernel_after_k1s_forward():
    """No __global__ function, namespace or type the backward's source
    declares carries ``flash_attention``: the benchmark takes every device
    record with that name for a K1 forward launch."""
    src = tbwd.SOURCE.read_text()
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)
    kernels = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
        code)
    assert {"attn_bwd_rowstats_kernel", "attn_bwd_dkdv_kernel",
            "attn_bwd_dkdv_reduce_kernel", "attn_bwd_dq_kernel"} \
        <= set(kernels)
    names = kernels + re.findall(
        r"\b(?:namespace|struct|class|using|typedef)\s+(\w+)", code)
    assert names and not [n for n in names if "flash_attention" in n]
    assert "flash_attention" not in code  # nor in any type or parameter


@pytest.mark.parametrize("shape,want", [
    ((1, 2, 16, 32, 132), 8),    # chatglm3-6b, 2048 keys: 64 blocks alone
    ((8, 16, 1, 8, 132), 1),     # bert-large, b 8, 512 keys: 1,024 blocks
    ((1, 1, 6, 1, 132), 6),      # too few blocks at any split: the group
    ((2, 2, 4, 100, 132), 1),    # enough blocks unsplit
])
def test_gqa_split_fills_the_card(shape, want):
    assert tbwd.gqa_split(*shape) == want


def test_backward_work_is_five_products_of_k1s_pairs():
    q, k, v = (torch.empty(s) for s in ((2, 100, 8, 64), (2, 100, 2, 64),
                                         (2, 100, 2, 64)))
    fwd_bytes, fwd_ops, pairs = costs.flash_work(q, k, v, True, 24, 0)
    nbytes, ops_n, bwd_pairs = costs.attention_bwd_work(q, k, v, True, 24, 0)
    assert bwd_pairs == pairs and 2 * ops_n == 5 * fwd_ops
    assert nbytes == 4 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())


# the backward's card cases: CARD_SWEEP's (head dims the kernels take),
# a fully masked row, GQA group 16 at chatglm3-6b's head dim, bert-large's
# non-causal shape (b 2), and a ragged 200-row case that splits its group
BWD_CARD_SWEEP = [c for c in CARD_SWEEP if c[5] in tfa.HEAD_DIMS] + [
    (1, 40, 40, 4, 2, 16, True, 8, -8, "float32"),
    (1, 40, 40, 4, 2, 16, True, 8, -8, "bfloat16"),
    (1, 256, 256, 32, 2, 128, True, 0, 0, "float32"),
    (1, 256, 256, 32, 2, 128, True, 0, 0, "bfloat16"),
    (2, 512, 512, 16, 16, 64, False, 0, 0, "float32"),
    (1, 200, 200, 16, 1, 32, True, 0, 0, "float32"),
]


def _bwd_on_card(dev, case, seed):
    b, sq, sk, hq, hkv, hd, causal, window, off, dt = case
    q, k, v = (torch.from_numpy(a).to(dev, TDT[dt])
               for a in _qkv(seed, b, sq, sk, hq, hkv, hd))
    kw = dict(causal=causal, window=window, kv_offset=off)
    out = tfa.flash_attention_kernel(q, k, v, **kw)
    dout = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32)).to(dev, TDT[dt])
    return (q, k, v, out, dout), kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(BWD_CARD_SWEEP)))
def test_backward_kernel_vs_plain_on_card(cuda_device, case):
    """Each gradient within 2e-5 (fp32) or 2e-2 (bf16) of its largest
    entry of the plain backward's, taken in fp32 on the same values."""
    dt = BWD_CARD_SWEEP[case][-1]
    args, kw = _bwd_on_card(cuda_device, BWD_CARD_SWEEP[case], 90 + case)
    got = tbwd.attention_bwd_kernel(*args, **kw)
    want = tbwd.attention_bwd_plain(*(t.float() for t in args), **kw)
    torch.cuda.synchronize()
    off = BWD_CARD_SWEEP[case][8]
    for g, w in zip(got, want):
        assert g.dtype == TDT[dt] and bool(torch.isfinite(g).all())
        err = float((g.float() - w).abs().max())
        assert err <= TOL[dt] * float(w.abs().max())
    if off < 0:  # rows with no visible key: a zero gradient
        assert not got[0][:, :-off].any()


@pytest.mark.gpu
def test_backward_kernel_is_deterministic(cuda_device):
    """No atomics, partial dK / dV summed in a fixed order: two runs give
    the same bits (this shape splits its group of 16 over blocks)."""
    case = (1, 256, 256, 32, 2, 128, True, 0, 0, "float32")
    args, kw = _bwd_on_card(cuda_device, case, 7)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert tbwd.gqa_split(1, 2, 16, 4, sms) > 1
    first = tbwd.attention_bwd_kernel(*args, **kw)
    second = tbwd.attention_bwd_kernel(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_backward_kernel_launches_on_its_tensors_device(dt):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda:1")
    args, kw = _bwd_on_card(dev, (1, 256, 256, 32, 2, 128, True, 0, 0, dt),
                            15)
    with torch.cuda.device(0):
        got = tbwd.attention_bwd_kernel(*args, **kw)
        want = tbwd.attention_bwd_plain(*(t.float() for t in args), **kw)
    torch.cuda.synchronize(dev)
    for g, w in zip(got, want):
        assert g.device == dev
        err = float((g.float() - w).abs().max())
        assert err <= TOL[dt] * float(w.abs().max())
