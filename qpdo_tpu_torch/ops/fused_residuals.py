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

import torch

from .. import kernels

_DUAL = ("Ax", "y", "mu", "ybar", "l", "u", "E", "Einv")
_PRIMAL = ("Qx", "q", "Aty", "x", "xbar", "Dinv")
_SCALAR = ("sigma", "cinv")


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


def fused_residuals(Ax, y, mu, ybar, l, u, E, Einv,
                    Qx, q, Aty, x, xbar, Dinv, sigma, cinv):
    """The residual block for dual arguments (B, m), primal (B, n) and
    sigma/cinv (B,), all of one dtype (float32 or float64) on one device.
    Returns (res_prim, res_prim_in, w, active, res_dual_in, rp, rd, rpi,
    rdi).  CUDA tensors launch the kernel (and count the launch in
    ``fused_residuals.launches``); CPU tensors take the plain version."""
    args = (Ax, y, mu, ybar, l, u, E, Einv, Qx, q, Aty, x, xbar, Dinv,
            sigma, cinv)
    if Ax.dim() != 2 or Qx.dim() != 2:
        raise ValueError("Ax must be (B, m) and Qx (B, n)")
    B, m = Ax.shape
    n = Qx.shape[1]
    shape = dict.fromkeys(_DUAL, (B, m))
    shape.update(dict.fromkeys(_PRIMAL, (B, n)))
    shape.update(dict.fromkeys(_SCALAR, (B,)))
    for name, t in zip(_DUAL + _PRIMAL + _SCALAR, args):
        if tuple(t.shape) != shape[name]:
            raise ValueError(f"{name} must be {shape[name]}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != Ax.dtype or t.device != Ax.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; Ax is "
                             f"{Ax.dtype} on {Ax.device}")
    if Ax.device.type == "cpu":
        return reference_residuals(*args)
    if Ax.device.type != "cuda":
        raise ValueError(f"fused_residuals: unsupported device {Ax.device}")
    if Ax.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_residuals: unsupported dtype {Ax.dtype}")
    for name, t in zip(_DUAL + _PRIMAL + _SCALAR, args):
        if not t.is_contiguous():
            raise ValueError(f"fused_residuals: {name} must be contiguous")
    new = lambda *s: torch.empty(s, dtype=Ax.dtype, device=Ax.device)
    res_prim, res_prim_in, w, active = (new(B, m) for _ in range(4))
    res_dual_in = new(B, n)
    norms = new(4, B)
    kernels.launch("residuals", Ax.dtype, Ax.device,
                   (*args, res_prim, res_prim_in, w, active, res_dual_in,
                    norms), (B, m, n))
    fused_residuals.launches += 1
    return (res_prim, res_prim_in, w, active, res_dual_in,
            norms[0], norms[1], norms[2], norms[3])


fused_residuals.launches = 0
