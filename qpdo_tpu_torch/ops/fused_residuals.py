"""Fused residual block of one solver step, batched.

Replaces the TPU kernel ``qpdo_tpu/ops/pallas_residuals.py:_kernel``
(l.47, entry ``fused_residuals`` l.159).  On a CUDA tensor the wrapper
launches the hand-written kernel ``qpdo_tpu_torch/csrc/residuals.cu``
(its header says what bounds it on the H100 and how the design answers);
on a CPU tensor it runs ``reference_residuals``, the same block as plain
tensor code, in the same operation order:

    res_prim    = Ax - clip(Ax + (E*E*cinv) y, l, u)          (outer)
    w           = Ax + mu (ybar - y/2)
    res_prim_in = Ax + mu (ybar - y) - clip(w, l, u)           (inner)
    active      = (w <= l) | (w >= u)                          (0/1, dtype of Ax)
    res_dual_in = Qx + q + sigma (x - xbar) + Aty
    rp  = ||Einv * res_prim||_inf        rpi = ||Einv * res_prim_in||_inf
    rd  = ||Dinv * (Qx + q + Aty)||_inf * cinv
    rdi = ||Dinv * res_dual_in||_inf * cinv

Every norm reduces over one problem's vector only, and propagates NaN.
"""

from __future__ import annotations

import collections

import torch

from .. import kernels

_NAMES = ("Ax", "y", "mu", "ybar", "l", "u", "E", "Einv",      # (B, m)
          "Qx", "q", "Aty", "x", "xbar", "Dinv",               # (B, n)
          "sigma", "cinv")                                     # (B,)


def reference_residuals(Ax, y, mu, ybar, l, u, E, Einv,
                        Qx, q, Aty, x, xbar, Dinv, sigma, cinv):
    """Plain version.  Returns (res_prim, res_prim_in, w, active,
    res_dual_in, rp, rd, rpi, rdi)."""
    sig = sigma[:, None]
    civ = cinv[:, None]
    rp = Ax - torch.clamp(Ax + (E * E * civ) * y, l, u)
    w = Ax + mu * (ybar - 0.5 * y)
    rpi = Ax + mu * (ybar - y) - torch.clamp(w, l, u)
    active = ((w <= l) | (w >= u)).to(Ax.dtype)
    df = Qx + q + sig * (x - xbar)
    rdi_vec = df + Aty
    rp_n = torch.amax(torch.abs(Einv * rp), dim=1)
    rpi_n = torch.amax(torch.abs(Einv * rpi), dim=1)
    rd_n = torch.amax(torch.abs(Dinv * (Qx + q + Aty)), dim=1) * cinv
    rdi_n = torch.amax(torch.abs(Dinv * rdi_vec), dim=1) * cinv
    return rp, rpi, w, active, rdi_vec, rp_n, rd_n, rpi_n, rdi_n


def kernel_outputs(B, m, n, dtype, device):
    """The kernel's output buffer and the nine contiguous views of it that
    the wrapper returns: res_prim, res_prim_in, w, active (B, m),
    res_dual_in (B, n), rp, rd, rpi, rdi (B,), one after the other."""
    out = torch.empty(4 * B * m + B * n + 4 * B, dtype=dtype, device=device)
    # the parts do not overlap and nothing records gradients through them,
    # so the split can skip autograd's view bookkeeping, which costs host
    # time on every call
    parts = out.unsafe_split_with_sizes((B * m,) * 4 + (B * n,) + (B,) * 4)
    return out, (parts[0].view(B, m), parts[1].view(B, m),
                 parts[2].view(B, m), parts[3].view(B, m),
                 parts[4].view(B, n), *parts[5:])


def _raise_first_mismatch(args, shapes):
    Ax = args[0]
    for name, t, shape in zip(_NAMES, args, shapes):
        if t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != Ax.dtype or t.device != Ax.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; Ax is "
                             f"{Ax.dtype} on {Ax.device}")


def fused_residuals(Ax, y, mu, ybar, l, u, E, Einv,
                    Qx, q, Aty, x, xbar, Dinv, sigma, cinv, *, out=None):
    """The residual block for dual arguments (B, m), primal (B, n) and
    sigma/cinv (B,), all of one dtype (float32 or float64) on one device.
    Returns (res_prim, res_prim_in, w, active, res_dual_in, rp, rd, rpi,
    rdi).  CUDA tensors launch the kernel (and count the launch, by dtype,
    in the Counter ``fused_residuals.launches``); CPU tensors take the
    plain version.

    ``out``, if given, is what ``kernel_outputs(B, m, n, dtype, device)``
    returned: the outputs are written into it and its views are returned,
    so a caller that calls the block again and again (the solver loop)
    allocates nothing per call.  Each call overwrites the last one's
    outputs."""
    args = (Ax, y, mu, ybar, l, u, E, Einv, Qx, q, Aty, x, xbar, Dinv,
            sigma, cinv)
    if Ax.dim() != 2 or Qx.dim() != 2:
        raise ValueError("Ax must be (B, m) and Qx (B, n)")
    B, m = Ax.shape
    n = Qx.shape[1]
    dtype, device = Ax.dtype, Ax.device
    shapes = [Ax.shape] * 8 + [(B, n)] * 6 + [(B,)] * 2
    if ([t.shape for t in args] != shapes
            or len({(t.dtype, t.device) for t in args}) != 1):
        _raise_first_mismatch(args, shapes)
    if out is not None:
        buf, outputs = out
        if (buf.dtype != dtype or buf.device != device
                or outputs[0].shape != (B, m) or outputs[4].shape != (B, n)):
            raise ValueError(f"out must be kernel_outputs{(B, m, n)} in "
                             f"{dtype} on {device}")
    if device.type == "cpu":
        ref = reference_residuals(*args)
        if out is None:
            return ref
        for o, r in zip(outputs, ref):
            o.copy_(r)
        return outputs
    if device.type != "cuda":
        raise ValueError(f"fused_residuals: unsupported device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_residuals: unsupported dtype {dtype}")
    if not all([t.is_contiguous() for t in args]):
        name = next(k for k, t in zip(_NAMES, args) if not t.is_contiguous())
        raise ValueError(f"fused_residuals: {name} must be contiguous")
    if out is None:
        buf, outputs = kernel_outputs(B, m, n, dtype, device)
    kernels.launch("residuals", dtype, (*args, buf), (B, m, n))
    fused_residuals.launches[dtype] += 1
    return outputs


fused_residuals.launches = collections.Counter()
