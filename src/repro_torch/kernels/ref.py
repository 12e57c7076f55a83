"""Plain torch versions of the state-space kernels, token by token; port
of ``repro/kernels/ref.py`` (``wkv6_ref``) with ``ssd_ref`` added.

Each runs its recurrence one token at a time in float32, exactly as
written, and is what :func:`repro_torch.kernels.wkv6.wkv6` and
:func:`repro_torch.kernels.ssd.ssd` run for CPU tensors and are held to
on the card. The reference has no ``ssd_ref``: its kernel test loops
``ssd_step`` by hand (``tests/test_ssd_kernel.py``); :func:`ssd_ref` is
that loop.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w_log, u, state0):
    """Sequential WKV-6 (token-by-token exact recurrence).

    r/k/v/w_log [B, S, H, N]; u [H, N]; state0 [B, H, N, N] (key-major).
    Per head: ``y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t``, then
    ``S_t = diag(exp w_t) S_{t-1} + k_t v_t^T``. Returns (y [B, S, H, N]
    in r's dtype, state [B, H, N, N] float32).
    """
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w_log))
    uf = u.to(torch.float32)
    st = state0.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        y = torch.einsum("bhk,bhkn->bhn", rt, st) \
            + torch.einsum("bhk,hk,bhk->bh", rt, uf, kt)[..., None] * vt
        st = st * torch.exp(wf[:, t])[..., None] \
            + torch.einsum("bhk,bhn->bhkn", kt, vt)
        ys.append(y)
    y = torch.stack(ys, 1) if ys else rf.new_zeros(r.shape)
    return y.to(r.dtype), st


def ssd_ref(x, dt, a_log, b, c, state0):
    """Sequential Mamba-2 SSD: :func:`repro_torch.models.mamba2.ssd_step`
    over the tokens.

    x [B, S, H, P]; dt [B, S, H]; a_log [H]; b/c [B, S, N] (shared by the
    heads); state0 [B, H, P, N]. Per head: ``S_t = exp(-exp(a_log) dt_t)
    S_{t-1} + dt_t x_t b_t^T``, ``y_t = S_t c_t``. Returns (y [B, S, H,
    P] in x's dtype, state [B, H, P, N] float32).
    """
    # imported here: models.mamba2 launches the kernels, whose modules
    # import this one
    from repro_torch.models.mamba2 import ssd_step
    st = state0.to(torch.float32)
    ys = []
    for t in range(x.shape[1]):
        y, st = ssd_step(x[:, t], dt[:, t], a_log, b[:, t], c[:, t], st)
        ys.append(y)
    y = torch.stack(ys, 1) if ys else x.new_zeros(x.shape)
    return y, st
