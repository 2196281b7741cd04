"""PyTorch port — the Mamba1 selective scan (kernel K3) against the JAX
reference:

* the plain version, and ``ops.mamba_scan`` on CPU tensors (which runs the
  plain version), against ``repro.kernels.ref.mamba_scan_ref`` and against
  the Pallas kernel through ``repro.kernels.ops.mamba_scan`` in interpret
  mode, over ``tests/test_kernels_mamba.py``'s sweep at its tolerances
  (fp32 1e-4, bf16 3e-2) on y and h;
* ``ops.mamba_scan``'s gradients (autograd through the plain version)
  against ``jax.vjp`` of the reference oracle, fp32, 1e-4 relative to each
  gradient's largest entry;
* the wrapper's refusals (CPU tensors, bad shapes) and a strided ``C``.

The CUDA kernel itself runs only on a card: its test carries the ``gpu``
marker and skips here (chip_smoke.py holds it against the plain version at
the serving path's shapes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

# tests/test_kernels_mamba.py's sweep
SWEEP = [
    # b, s, di, n, chunk, block_di, dtype
    (2, 37, 16, 8, 16, 16, "float32"),
    (1, 128, 64, 4, 32, 32, "float32"),
    (2, 20, 32, 16, 8, 16, "bfloat16"),
    (1, 7, 8, 4, 4, 8, "float32"),
    (3, 65, 48, 8, 16, 16, "float32"),
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # the reference's tolerances
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, b, s, di, n):
    """The reference test's distributions: decays in (0, 1], small inputs,
    a nonzero incoming state."""
    rng = np.random.default_rng(seed)
    return (np.exp(-np.abs(rng.normal(size=(b, s, di, n)) * 0.3)),
            rng.normal(size=(b, s, di, n)) * 0.2,
            rng.normal(size=(b, s, n)),
            (rng.normal(size=(b, di, n)) * 0.1).astype(np.float32))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_plain_and_op_match_reference_and_pallas(case):
    b, s, di, n, chunk, bdi, dt = SWEEP[case]
    da, dbx, c, h0 = _inputs(case, b, s, di, n)
    jin = [jnp.asarray(a, JDT[dt]) for a in (da, dbx, c)]
    y_ref, h_ref = jref.mamba_scan_ref(*jin, jnp.asarray(h0))
    y_pal, h_pal = jops.mamba_scan(*jin, jnp.asarray(h0), chunk=chunk,
                                   block_di=bdi)
    tin = [torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dt])
           for a in (da, dbx, c)]
    th0 = torch.from_numpy(h0)
    launches = tms.launches
    for fn in (tms.mamba_scan_plain, tops.mamba_scan):
        y, h = fn(*tin, th0)
        assert y.dtype == TDT[dt] and y.shape == (b, s, di)
        assert h.dtype == torch.float32 and h.shape == (b, di, n)
        for want_y, want_h in ((y_ref, h_ref), (y_pal, h_pal)):
            assert _err(want_y.astype(jnp.float32), y.float()) < TOL[dt]
            assert _err(want_h, h) < TOL[dt]
    assert tms.launches == launches  # a CPU tensor never reaches the kernel


@pytest.mark.parametrize("case", [0, 3])
def test_op_gradients_match_reference_vjp(case):
    b, s, di, n, _, _, _ = SWEEP[case]
    arrs = [np.asarray(a, np.float32) for a in _inputs(10 + case, b, s, di,
                                                        n)]
    rng = np.random.default_rng(20 + case)
    ct_y = rng.normal(size=(b, s, di)).astype(np.float32)
    ct_h = rng.normal(size=(b, di, n)).astype(np.float32)
    _, vjp = jax.vjp(jref.mamba_scan_ref, *map(jnp.asarray, arrs))
    want = vjp((jnp.asarray(ct_y), jnp.asarray(ct_h)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, h = tops.mamba_scan(*leaves)
    torch.autograd.backward((y, h), (torch.from_numpy(ct_y),
                                     torch.from_numpy(ct_h)))
    for w, t in zip(want, leaves):
        w = np.asarray(w)
        assert np.isfinite(t.grad.numpy()).all()
        assert _err(w, t.grad) / max(1.0, float(np.abs(w).max())) < 1e-4


def test_strided_cmat_is_read_through_its_strides():
    """C as the model makes it: the last n columns of x_proj's output."""
    b, s, di, n, r = 2, 9, 8, 4, 3
    da, dbx, c, h0 = (torch.from_numpy(np.asarray(a, np.float32))
                      for a in _inputs(5, b, s, di, n))
    proj = torch.randn(b, s, r + 2 * n, generator=torch.Generator()
                       .manual_seed(0))
    cmat = proj[..., r + n:]
    assert not cmat.is_contiguous() and cmat.stride(2) == 1
    y, h = tops.mamba_scan(da, dbx, cmat, h0)
    y2, h2 = tms.mamba_scan_plain(da, dbx, cmat.contiguous(), h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_kernel_wrapper_refuses_cpu_tensors():
    da, dbx, c, h0 = (torch.from_numpy(np.asarray(a, np.float32))
                      for a in _inputs(6, 1, 4, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tms.mamba_scan_kernel(da, dbx, c, h0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_kernel_vs_plain_on_card(cuda_device, case):
    b, s, di, n, _, _, dt = SWEEP[case]
    da, dbx, c, h0 = (torch.from_numpy(np.asarray(a, np.float32))
                      .to(cuda_device) for a in _inputs(case, b, s, di, n))
    da, dbx, c = (t.to(TDT[dt]) for t in (da, dbx, c))
    y, h = tms.mamba_scan_kernel(da, dbx, c, h0)
    y2, h2 = tms.mamba_scan_plain(da, dbx, c, h0)
    torch.cuda.synchronize()
    assert float((y.float() - y2.float()).abs().max()) < TOL[dt]
    assert float((h - h2).abs().max()) < TOL[dt]
