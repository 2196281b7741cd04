"""The Mamba1 selective scan: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro/kernels/mamba_scan.py::mamba_scan_bdn`` (the Pallas TPU
kernel), the prefill / append scan of the SSM serving path. The kernel is
``csrc/mamba_scan.cu``, CUDA C++ for ``sm_90a``: one thread per (row,
channel, group of 4 states), each walking the whole sequence with its
states in registers and the next few steps' inputs loaded ahead; ``y_t``
is a shuffle sum over the channel's ``n / 4`` lanes. It computes what the
Pallas kernel computes, not its tiling: no time chunks, no padding.

Build and binding as ``kernels/flash_attention.py``: ``kernels.build``
compiles the source at first use into ``build/repro_torch/`` and
``ctypes`` loads its C entry; the wrapper checks devices, dtypes, shapes,
strides and alignment, allocates the outputs with ``torch.empty``,
launches under the inputs' device on its current stream
(``kernels.build.launch_device``) and raises if the launch returned a
CUDA error. ``cmat`` may be a strided view (the model passes a
split of ``x_proj``'s output): the kernel reads it through its strides.

:func:`mamba_scan_plain` is the sequential fp32 loop of
``ref.mamba_scan_ref``: the CPU lowering the tests hold against JAX, and
the yardstick ``chip_smoke.py`` holds the kernel against on the card.
``ops.mamba_scan`` picks between the two by device and adds the backward.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.analysis import costs
from repro_torch.kernels import build as kbuild

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mamba_scan.cu"
D_STATES = (4, 8, 16, 32)  # 4 states per lane; compiled for each

# kernel launches since the caller last set this to 0 (one per launch, and
# nowhere else): chip_smoke.py reads it to show the serve path ran the kernel
launches = 0

_lib = None


def _entry():
    global _lib
    if _lib is None:
        lib = kbuild.load(SOURCE)
        fn = lib.mamba_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.mamba_scan_fwd


def mamba_scan_kernel(da, dbx, cmat, h0):
    """Launch the CUDA kernel. da / dbx (b, s, di, n) contiguous and cmat
    (b, s, n) with unit last stride, all in one dtype (float32 or
    bfloat16); h0 (b, di, n) float32 contiguous; n in ``D_STATES``.
    Returns (y (b, s, di) in da's dtype, h (b, di, n) float32)."""
    global launches
    dev = kbuild.launch_device("mamba_scan_kernel", da=da, dbx=dbx,
                               cmat=cmat, h0=h0)
    if da.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {da.dtype}")
    if dbx.dtype != da.dtype or cmat.dtype != da.dtype:
        raise ValueError(f"dbx {dbx.dtype} and cmat {cmat.dtype} must match "
                         f"da's {da.dtype}")
    if h0.dtype != torch.float32:
        raise ValueError(f"h0 must be float32, got {h0.dtype}")
    if da.ndim != 4 or dbx.shape != da.shape:
        raise ValueError(f"bad shapes da {tuple(da.shape)}, dbx "
                         f"{tuple(dbx.shape)}")
    b, s, di, n = da.shape
    if cmat.shape != (b, s, n) or h0.shape != (b, di, n):
        raise ValueError(f"cmat {tuple(cmat.shape)} / h0 {tuple(h0.shape)} "
                         f"do not fit da {tuple(da.shape)}")
    if n not in D_STATES:
        raise ValueError(f"kernel takes d_state in {D_STATES}, got {n}")
    if not (da.is_contiguous() and dbx.is_contiguous()
            and h0.is_contiguous()):
        raise ValueError("da, dbx and h0 must be contiguous")
    if cmat.stride(2) != 1:
        raise ValueError("cmat's last stride must be 1")
    if any(t.data_ptr() % (4 * t.element_size()) for t in (da, dbx, h0)):
        raise ValueError("da, dbx and h0 must be aligned to 4 elements "
                         "(vector loads)")
    y = torch.empty((b, s, di), dtype=da.dtype, device=da.device)
    if s == 0 or b * di == 0:
        return y, h0.clone()
    h = torch.empty_like(h0)
    with torch.cuda.device(dev):
        rc = _entry()(da.data_ptr(), dbx.data_ptr(), cmat.data_ptr(),
                      h0.data_ptr(), y.data_ptr(), h.data_ptr(), b, s, di, n,
                      cmat.stride(0), cmat.stride(1),
                      int(da.dtype == torch.bfloat16),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise kbuild.KernelLaunchError(
            f"mamba_scan launch failed: CUDA error {rc}")
    launches += 1
    if costs.counting():
        costs.record_launch("mamba_scan", *costs.scan_work(da, dbx, cmat, h0))
    return y, h


def mamba_scan_plain(da, dbx, cmat, h0):
    """Sequential scan in fp32 (``ref.mamba_scan_ref``): h_t = da_t * h +
    dbx_t, y_t = sum_n h_t * C_t; y in da's dtype, h float32. Same contract
    as :func:`mamba_scan_kernel`, with any strides and h0 dtype."""
    h = h0.float()
    ys = []
    for t in range(da.shape[1]):
        h = da[:, t].float() * h + dbx[:, t].float()
        ys.append((h * cmat[:, t, None, :].float()).sum(-1))
    y = (torch.stack(ys, dim=1) if ys
         else da.new_zeros(da.shape[0], 0, da.shape[2]))
    return y.to(da.dtype), h
