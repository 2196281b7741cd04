"""PyTorch port — paged attention: the plain version (the CPU lowering and
the yardstick the CUDA kernel is held against on the card) against the JAX
reference's gather oracle ``ref.paged_attention_ref`` and its Pallas
kernel in interpret mode (blockspec variant), plus the paged-scatter
capacity regression and the dispatch's launch counter.

The CUDA kernel itself runs only on a card: its test here carries the
``gpu`` marker and skips (chip_smoke.py holds it against the plain version
at the main path's shapes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import blocks as tblocks

torch.set_num_threads(2)

# the reference's sweep (tests/test_kernels_paged.py) plus one case at the
# main path's GQA group (hq 32 on hkv 2: g = 16) with a narrow head dim
SWEEP = [
    # b, sq, hq, hkv, hd, nb, bs, n_tbl, kv_lens, window, dtype
    (2, 1, 4, 2, 16, 12, 4, 4, [9, 16], 0, "float32"),       # decode GQA
    (2, 1, 4, 4, 16, 12, 4, 4, [1, 13], 0, "float32"),       # MHA ragged
    (3, 1, 8, 2, 16, 16, 8, 3, [24, 5, 17], 0, "float32"),   # g=4, bs=8
    (2, 1, 4, 2, 16, 12, 4, 4, [9, 16], 3, "float32"),       # window
    (2, 4, 4, 2, 16, 14, 4, 5, [11, 20], 0, "float32"),      # append
    (2, 5, 4, 2, 16, 14, 4, 6, [5, 21], 5, "float32"),       # append+win
    (2, 1, 4, 2, 16, 12, 16, 2, [9, 30], 0, "bfloat16"),     # bf16, bs=16
    (2, 3, 2, 2, 32, 10, 8, 3, [19, 8], 0, "bfloat16"),      # bf16 append
    (3, 2, 32, 2, 16, 16, 16, 4, [50, 2, 33], 0, "float32"),  # g=16
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # the reference's tolerances


def make_case(seed, b, sq, hq, hkv, hd, nb, bs, n_tbl, kv_lens):
    """Random pool + ragged per-row tables (numpy): row r holds kv_lens[r]
    live tokens, the sq new ones at its tail; live blocks are a random
    disjoint subset of the pool, the rest of each table is -1."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, hq, hd)).astype(np.float32)
    k_pool = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    tables = np.full((b, n_tbl), -1, np.int32)
    free = list(rng.permutation(nb))
    for r, ln in enumerate(kv_lens):
        for j in range(-(-max(ln, 1) // bs)):
            tables[r, j] = free.pop()
    kv_len = np.asarray(kv_lens, np.int32)
    return q, k_pool, v_pool, tables, kv_len - sq, kv_len


def _jax(arrs, dt):
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    q, kp, vp, tb, off, ln = arrs
    return (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(tb), jnp.asarray(off), jnp.asarray(ln))


def _torch(arrs, dt):
    tdt = getattr(torch, dt)
    q, kp, vp, tb, off, ln = arrs
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
            torch.from_numpy(vp).to(tdt), torch.from_numpy(tb),
            torch.from_numpy(off), torch.from_numpy(ln))


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32)
                               - t.float().numpy())))


@pytest.mark.parametrize("b,sq,hq,hkv,hd,nb,bs,n_tbl,kv_lens,window,dt",
                         SWEEP)
def test_plain_vs_reference_and_blockspec(b, sq, hq, hkv, hd, nb, bs, n_tbl,
                                          kv_lens, window, dt):
    arrs = make_case(7, b, sq, hq, hkv, hd, nb, bs, n_tbl, kv_lens)
    jargs, targs = _jax(arrs, dt), _torch(arrs, dt)
    got = tpa.paged_attention_plain(*targs, causal=True, window=window)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    want = jref.paged_attention_ref(*jargs, causal=True, window=window)
    assert _err(want, got) < TOL[dt]
    pallas = jpa.paged_attention_pool(*jargs, causal=True, window=window,
                                      interpret=True, variant="blockspec")
    assert _err(pallas, got) < TOL[dt]


@pytest.mark.parametrize("q_lens", [[4, 1], [3, 0], [1, 4]])
def test_plain_ragged_q_lens(q_lens):
    """Ragged per-row query counts (prefill chunk, decode 1, idle 0):
    padded query positions come out exactly zero, real positions match the
    reference attending only kv_offset + q_len_r tokens."""
    b, sq, hq, hkv, hd, nb, bs, n_tbl = 2, 4, 4, 2, 16, 14, 4, 5
    kv_off = np.asarray([7, 9], np.int32)
    q, kp, vp, tb, _, _ = make_case(8, b, sq, hq, hkv, hd, nb, bs, n_tbl,
                                    list(kv_off + sq))
    kv_len = kv_off + np.asarray(q_lens, np.int32)
    ql = np.asarray(q_lens, np.int32)
    arrs = (q, kp, vp, tb, kv_off, kv_len)
    jargs, targs = _jax(arrs, "float32"), _torch(arrs, "float32")
    got = tpa.paged_attention_plain(*targs, causal=True,
                                    q_lens=torch.from_numpy(ql))
    want = jref.paged_attention_ref(*jargs, causal=True,
                                    q_lens=jnp.asarray(ql))
    assert _err(want, got) < 2e-5
    pallas = jpa.paged_attention_pool(*jargs, causal=True, interpret=True,
                                      variant="blockspec",
                                      q_lens=jnp.asarray(ql))
    assert _err(pallas, got) < 2e-5
    for row, n in enumerate(q_lens):
        assert torch.all(got[row, n:] == 0)


def test_scatter_overflow_leaves_last_block_untouched():
    """Regression of the reference's scatter fix: tokens past table capacity
    are DROPPED — clipping the block index would route them into the row's
    last allocated block. The in-place scatter must agree with the
    reference's functional one in both cases."""
    rng = np.random.default_rng(9)
    nb, bs, hkv, hd = 4, 4, 2, 8  # capacity 2 blocks = 8 tokens
    pool = {n: rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
            for n in ("k", "v")}
    tables = np.asarray([[2, 1]], np.int32)  # full table, last block = 1
    k = rng.normal(size=(1, 1, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(1, 1, hkv, hd)).astype(np.float32)
    for offset in (8, 5):  # at capacity (dropped), inside (lands)
        tcache = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
        tblocks.paged_kv_scatter(tcache, torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(tables),
                                 torch.tensor([offset], dtype=torch.int32))
        jnew = jblocks.paged_kv_scatter(
            {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(tables),
            jnp.asarray([offset], jnp.int32))
        for n in ("k", "v"):
            np.testing.assert_array_equal(tcache[n].numpy(),
                                          np.asarray(jnew[n]))
        if offset == 8:
            np.testing.assert_array_equal(tcache["k"].numpy(), pool["k"])
        else:
            np.testing.assert_array_equal(tcache["k"][1, 1].numpy(), k[0, 0])


def test_dispatch_counts_no_launch_on_cpu():
    """CPU tensors take the plain version: the kernel's launch counter
    stays 0, and the kernel wrapper itself refuses CPU tensors."""
    arrs = make_case(10, *SWEEP[0][:9])
    targs = _torch(arrs, "float32")
    before = tpa.launches
    out = ops.paged_attention(*targs, causal=True)
    assert tpa.launches == before
    torch.testing.assert_close(
        out, tpa.paged_attention_plain(*targs, causal=True), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_kernel(*targs, causal=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_kernel_vs_plain_on_card(cuda_device, case):
    b, sq, hq, hkv, hd, nb, bs, n_tbl, kv_lens, window, dt = SWEEP[case]
    arrs = make_case(11, b, sq, hq, hkv, hd, nb, bs, n_tbl, kv_lens)
    targs = [t.to(cuda_device) for t in _torch(arrs, dt)]
    got = tpa.paged_attention_kernel(*targs, causal=True, window=window)
    want = tpa.paged_attention_plain(*targs, causal=True, window=window)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < TOL[dt]
