"""Channel equalization: MMSE / ZF for 1 layer x N rx ports, and MMSE for
L layers x N rx ports.

Port of ``srsran_edgeric_5g_tpu/ops/equalizer.py``.  The 1xN MMSE is the
reference's equalize_mmse_1xn.h:42-95, vectorised over all REs:

    x_hat = sum_p conj(h_p) y_p * |h|^2 / (|h|^4 + sum_p |h_p|^2 nvar_p)
    nvar_out = sum_p |h_p|^2 nvar_p / (|h|^4 + ...)        (unity gain)

with the reference's abnormal-input policy: ports with non-finite/zero
channel or non-positive noise variance are excluded; REs with no usable
port produce x_hat = 0 and nvar_out = +inf (the demapper emits zero LLRs).

The L-layer paths solve x = (H^H W H + I)^-1 H^H W y per RE with per-port
noise whitening W = diag(1/nvar_p) and unbias each layer to unity gain
(g_l = 1 - [(A+I)^-1]_ll).  The inverse is the reference's closed form:
the Hermitian 2x2 formula, and for L = 4 the blockwise Schur complement;
only other L go through ``torch.linalg.inv``.  The slot receiver's path is
``mmse_equalize_timeinv_grid``: the channel estimate is constant over the
data symbols, so the weights are computed once per subcarrier.
"""

from __future__ import annotations

import functools

import torch


def _port_validity(h: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    h_norm = h.real ** 2 + h.imag ** 2
    return (torch.isfinite(h_norm) & (h_norm > 0)
            & torch.isfinite(noise_var) & (noise_var > 0))


def equalize_mmse_1xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                      tx_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """MMSE-equalize one spatial layer from N receive ports.

    Args:
      y: received REs, shape (ports, ...).
      h: channel estimates, shape (ports, ...) (broadcastable to y).
      noise_var: per-port noise variance, (ports, ...) broadcastable.
      tx_scaling: transmit amplitude scaling applied to the channel.

    Returns (x_hat complex64, nvar_out float32) with the ports axis reduced.
    """
    h = h * tx_scaling
    h_norm = h.real ** 2 + h.imag ** 2
    nv = torch.as_tensor(noise_var, device=h.device).to(torch.float32).expand(h_norm.shape)
    valid = _port_validity(h, nv)

    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h_norm = torch.where(valid, h_norm, 0.0)
    ch_mod_sq = torch.sum(h_norm, dim=0)
    nvar_acc = torch.sum(torch.where(valid, h_norm * nv, 0.0), dim=0)
    mf = torch.sum(torch.where(valid, y * torch.conj(h), zero), dim=0)

    ok = ((ch_mod_sq > 0) & torch.isfinite(ch_mod_sq)
          & (nvar_acc > 0) & torch.isfinite(nvar_acc))
    denom = ch_mod_sq * ch_mod_sq + nvar_acc
    d_rcp = torch.where(ok, 1.0 / torch.where(ok, denom, 1.0), 0.0)

    x_hat = torch.where(ok, mf * (ch_mod_sq * d_rcp), zero)
    nvar_out = torch.where(ok, nvar_acc * d_rcp, float("inf"))
    return x_hat.to(torch.complex64), nvar_out.to(torch.float32)


def equalize_mmse_2xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                      tx_scaling: float = 1.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """MMSE for 2 layers x N rx ports with the closed-form 2x2 inverse.

    Args:
      y: (ports, ...) received REs.
      h: (ports, 2, ...) channel matrix per RE.
      noise_var: per-port noise variance broadcastable to y.

    Returns ((2, ...) x_hat, (2, ...) nvar_out), nvar_out = (1 - g)/g.
    """
    h = h * tx_scaling
    nv = torch.as_tensor(noise_var, device=y.device).to(torch.float32).expand(y.shape)
    w = 1.0 / torch.clamp(nv, min=1e-30)
    hw = h * w[:, None]
    a00 = torch.sum(torch.conj(h[:, 0]) * hw[:, 0], dim=0).real
    a11 = torch.sum(torch.conj(h[:, 1]) * hw[:, 1], dim=0).real
    a01 = torch.sum(torch.conj(h[:, 0]) * hw[:, 1], dim=0)
    z0 = torch.sum(torch.conj(hw[:, 0]) * y, dim=0)
    z1 = torch.sum(torch.conj(hw[:, 1]) * y, dim=0)

    # (A + I)^-1 with the noise already whitened to unit variance.
    b00 = a00 + 1.0
    b11 = a11 + 1.0
    det = b00 * b11 - (a01 * torch.conj(a01)).real
    det = torch.clamp(det, min=1e-30)
    x0 = (b11 * z0 - a01 * z1) / det
    x1 = (b00 * z1 - torch.conj(a01) * z0) / det

    g0 = torch.clamp(1.0 - b11 / det, min=1e-6)
    g1 = torch.clamp(1.0 - b00 / det, min=1e-6)
    x_hat = torch.stack([x0 / g0, x1 / g1]).to(torch.complex64)
    nv_out = torch.stack([(1.0 - g0) / g0, (1.0 - g1) / g1]).to(torch.float32)
    return x_hat, nv_out


def _inv2(b: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched (..., 2, 2) matrices."""
    det = b[..., 0, 0] * b[..., 1, 1] - b[..., 0, 1] * b[..., 1, 0]
    d = 1.0 / det
    row0 = torch.stack([b[..., 1, 1] * d, -b[..., 0, 1] * d], dim=-1)
    row1 = torch.stack([-b[..., 1, 0] * d, b[..., 0, 0] * d], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _inv_small(b: torch.Tensor) -> torch.Tensor:
    """Batched inverse of tiny Hermitian-PD (..., L, L) Gram matrices: the
    closed form for L = 1 and 2, the blockwise 2x2 Schur complement for
    L = 4 (the Schur complement of A + I stays invertible), linalg.inv
    otherwise."""
    n = b.shape[-1]
    if n == 1:
        return 1.0 / b
    if n == 2:
        return _inv2(b)
    if n == 4:
        mm = functools.partial(torch.einsum, "...ij,...jk->...ik")
        a, b12 = b[..., :2, :2], b[..., :2, 2:]
        c, d = b[..., 2:, :2], b[..., 2:, 2:]
        ai = _inv2(a)
        si = _inv2(d - mm(c, mm(ai, b12)))
        aib = mm(ai, b12)
        sicai = mm(si, mm(c, ai))
        tl = ai + mm(aib, sicai)
        tr = -mm(aib, si)
        bl = -sicai
        top = torch.cat([tl, tr], dim=-1)
        bot = torch.cat([bl, si], dim=-1)
        return torch.cat([top, bot], dim=-2)
    return torch.linalg.inv(b)


def _whitened(h: torch.Tensor, noise_var: torch.Tensor, shape) -> torch.Tensor:
    """h * diag(1/nvar_p) with the noise variance broadcast to ``shape``
    (the per-port axis first, the layer axis after it in h)."""
    nv = torch.as_tensor(noise_var, device=h.device).to(torch.float32).expand(shape)
    return h * (1.0 / torch.clamp(nv, min=1e-30))[:, None]


def equalize_mmse_lxn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                      tx_scaling: float = 1.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """MMSE for L layers x N rx ports, per RE.

    Args:
      y: (ports, ...) received REs.
      h: (ports, L, ...) channel matrix per RE.
      noise_var: per-port noise variance broadcastable to y.

    Returns ((L, ...) x_hat, (L, ...) nvar_out), nvar_out = (1 - g)/g.
    """
    h = h * tx_scaling
    nof_layers = h.shape[1]
    hw = _whitened(h, noise_var, y.shape)
    a = torch.einsum("pl...,pm...->...lm", torch.conj(h), hw)
    z = torch.einsum("pl...,p...->...l", torch.conj(hw), y)
    b = a + torch.eye(nof_layers, dtype=a.dtype, device=a.device)
    binv = _inv_small(b)
    xw = torch.einsum("...lm,...m->...l", binv, z)
    g = torch.clamp(1.0 - torch.diagonal(binv, dim1=-2, dim2=-1).real, min=1e-6)
    x_hat = torch.movedim(xw / g, -1, 0).to(torch.complex64)
    nv_out = torch.movedim((1.0 - g) / g, -1, 0).to(torch.float32)
    return x_hat, nv_out


def mmse_weights_lxn(h: torch.Tensor, noise_var: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The LxN MMSE combining weights of a time-invariant channel estimate.

    Args:
      h: (P, L, ..., w) channel estimate (no symbol axis).
      noise_var: per-port noise variance broadcastable to (P, ..., w).

    Returns (weights (..., w, L, P) complex64 with the unbias folded in,
    nv_out (..., w, L) float32), so that x_hat = W y per data RE equals
    ``equalize_mmse_lxn``.  nv_out is [(A+I)^-1]_ll / g_l taken directly:
    the (1 - g)/g form cancels to 0 in float32 at high SNR, and a zero noise
    variance makes the demapper return all-zero LLRs.
    """
    nof_layers, n_ports = h.shape[1], h.shape[0]
    hw = _whitened(h, noise_var, h.shape[:1] + h.shape[2:])
    if nof_layers in (1, 2, 4):
        binv, g = _binv_scalars(h, hw, nof_layers)
        wts = torch.stack(
            [torch.stack(
                [_weight(binv, g, hw[p], l) for p in range(n_ports)], dim=-1)
             for l in range(nof_layers)], dim=-2).to(torch.complex64)
        nv_out = torch.stack(
            [torch.clamp(binv[(l, l)].real, min=1e-30) / g[l]
             for l in range(nof_layers)], dim=-1).to(torch.float32)
        return wts, nv_out

    a = torch.einsum("pl...,pm...->...lm", torch.conj(h), hw)
    b = a + torch.eye(nof_layers, dtype=a.dtype, device=a.device)
    binv = _inv_small(b)
    diag = torch.diagonal(binv, dim1=-2, dim2=-1).real
    g = torch.clamp(1.0 - diag, min=1e-6)
    wts = torch.einsum("...lm,pm...->...lp", binv, torch.conj(hw))
    wts = (wts / g[..., None]).to(torch.complex64)
    nv_out = (torch.clamp(diag, min=1e-30) / g).to(torch.float32)
    return wts, nv_out


def mmse_equalize_timeinv(y: torch.Tensor, h: torch.Tensor,
                          noise_var: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weights-once MMSE equalisation of a time-invariant channel.

    Args:
      y: (P, B, n, w) received data REs (n = data symbols).
      h: (P, L, B, w) channel estimate (constant over n).
      noise_var: per-port noise variance broadcastable to (P, B, w).

    Returns (x_hat (B, L, n, w) layer-major, nv_out (B, L, w)).
    """
    nof_layers = h.shape[1]
    hw = _whitened(h, noise_var, h.shape[:1] + h.shape[2:])
    binv, g = _binv_scalars(h, hw, nof_layers)
    xs, nvs = [], []
    for l in range(nof_layers):
        acc = None
        for p in range(h.shape[0]):
            term = _weight(binv, g, hw[p], l)[:, None, :] * y[p]   # (B, n, w)
            acc = term if acc is None else acc + term
        xs.append(acc)
        nvs.append(torch.clamp(binv[(l, l)].real, min=1e-30) / g[l])
    return (torch.stack(xs, dim=1).to(torch.complex64),
            torch.stack(nvs, dim=1).to(torch.float32))


def mmse_equalize_timeinv_grid(y: torch.Tensor, h: torch.Tensor,
                               noise_var: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mmse_equalize_timeinv`` on the receive grid's own layout.

    Args:
      y: (S, P, n, U, w) received data REs as sliced from the per-antenna
         grid.
      h: (S, P, L, U, w) channel estimate (constant over n).
      noise_var: broadcastable to (S, P, U, w).

    Returns (x_hat (S, n, U, w, L) complex64, nv_out (S, U, w, L) float32).
    With the layer axis minor, flattening (n, w, L) per (S, U) row and
    expanding the last axis by Qm is the TS 38.211 layer interleave
    d(L*i + l).
    """
    nof_layers = h.shape[2]
    nv = torch.as_tensor(noise_var, device=h.device).to(torch.float32).expand(
        h.shape[:2] + h.shape[3:])                              # (S, P, U, w)
    hw = h * (1.0 / torch.clamp(nv, min=1e-30))[:, :, None]
    ht = h.permute(1, 2, 0, 3, 4)       # (P, L, S, U, w)
    hwt = hw.permute(1, 2, 0, 3, 4)
    binv, g = _binv_scalars(ht, hwt, nof_layers)             # entries (S, U, w)
    xs, nvs = [], []
    for l in range(nof_layers):
        acc = None
        for p in range(h.shape[1]):
            term = _weight(binv, g, hwt[p], l)[:, None] * y[:, p]  # (S, n, U, w)
            acc = term if acc is None else acc + term
        xs.append(acc)
        nvs.append(torch.clamp(binv[(l, l)].real, min=1e-30) / g[l])
    return (torch.stack(xs, dim=-1).to(torch.complex64),
            torch.stack(nvs, dim=-1).to(torch.float32))


def _weight(binv: dict, g: list, hw_p: torch.Tensor, l: int) -> torch.Tensor:
    """Layer l's combining weight on one port, unbias folded in:
    sum_m [(A+I)^-1]_lm conj(hw_pm) / g_l, with ``hw_p`` that port's
    (L, ...) whitened channel."""
    return sum(binv[(l, m)] * torch.conj(hw_p[m]) for m in range(len(g))) / g[l]


def _binv_scalars(h: torch.Tensor, hw: torch.Tensor, nof_layers: int):
    """(A + I)^-1 of the whitened Gram as a dict of (...,) scalar tensors.

    ``h``, ``hw``: (P, L, ...).  Returns (binv, g): binv[(l, m)] =
    [(A+I)^-1]_lm and g[l] = max(1 - Re binv[(l, l)], 1e-6).  L = 1 and 2
    invert in closed form, L = 4 by 2x2 blocks (the Schur complement of a
    Hermitian PD matrix stays Hermitian PD)."""
    if nof_layers not in (1, 2, 4):
        raise ValueError(f"closed-form inverse for L in (1, 2, 4), got {nof_layers}")

    def gram(l, m):                     # a_lm = sum_p conj(h_pl) hw_pm
        return torch.sum(torch.conj(h[:, l]) * hw[:, m], dim=0)

    def inv2h(b00, b01, b11):
        """Hermitian [[b00, b01], [conj(b01), b11]] inverse (b00, b11 real)
        -> (i00, i01, i11)."""
        det = b00 * b11 - (b01.real ** 2 + b01.imag ** 2)
        d = 1.0 / det
        return b11 * d, -b01 * d, b00 * d

    if nof_layers == 1:
        binv = {(0, 0): 1.0 / (gram(0, 0).real + 1.0)}
    elif nof_layers == 2:
        i00, i01, i11 = inv2h(gram(0, 0).real + 1.0, gram(0, 1),
                              gram(1, 1).real + 1.0)
        binv = {(0, 0): i00, (0, 1): i01, (1, 0): torch.conj(i01), (1, 1): i11}
    else:
        # B = [[A, C], [C^H, D]] in 2x2 blocks; E = A^-1 C, S = D - C^H E.
        a00 = gram(0, 0).real + 1.0
        a01 = gram(0, 1)
        a11 = gram(1, 1).real + 1.0
        c00, c01 = gram(0, 2), gram(0, 3)
        c10, c11 = gram(1, 2), gram(1, 3)
        d00 = gram(2, 2).real + 1.0
        d01 = gram(2, 3)
        d11 = gram(3, 3).real + 1.0
        ai00, ai01, ai11 = inv2h(a00, a01, a11)
        ai10 = torch.conj(ai01)
        e00 = ai00 * c00 + ai01 * c10
        e01 = ai00 * c01 + ai01 * c11
        e10 = ai10 * c00 + ai11 * c10
        e11 = ai10 * c01 + ai11 * c11
        # S = D - C^H E (Hermitian: s00, s11 real).
        s00 = d00 - (torch.conj(c00) * e00 + torch.conj(c10) * e10).real
        s01 = d01 - (torch.conj(c00) * e01 + torch.conj(c10) * e11)
        s11 = d11 - (torch.conj(c01) * e01 + torch.conj(c11) * e11).real
        si00, si01, si11 = inv2h(s00, s01, s11)
        si10 = torch.conj(si01)
        # Top-right block -E Si; the bottom-left is its conjugate transpose.
        tr00 = -(e00 * si00 + e01 * si10)
        tr01 = -(e00 * si01 + e01 * si11)
        tr10 = -(e10 * si00 + e11 * si10)
        tr11 = -(e10 * si01 + e11 * si11)
        # Top-left: A^-1 + E Si E^H = A^-1 + (-TR) E^H.
        tl00 = ai00 - (tr00 * torch.conj(e00) + tr01 * torch.conj(e01))
        tl01 = ai01 - (tr00 * torch.conj(e10) + tr01 * torch.conj(e11))
        tl11 = ai11 - (tr10 * torch.conj(e10) + tr11 * torch.conj(e11))
        binv = {(0, 0): tl00, (0, 1): tl01, (1, 1): tl11,
                (0, 2): tr00, (0, 3): tr01, (1, 2): tr10, (1, 3): tr11,
                (2, 2): si00, (2, 3): si01, (3, 3): si11}
        for (l, m) in list(binv):
            if m > l:
                binv[(m, l)] = torch.conj(binv[(l, m)])
        binv[(1, 0)] = torch.conj(binv[(0, 1)])
    g = [torch.clamp(1.0 - binv[(l, l)].real, min=1e-6)
         for l in range(nof_layers)]
    return binv, g


def equalize_zf_1xn(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                    tx_scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero forcing: x_hat = sum conj(h) y / sum |h|^2, with the 1xN MMSE's
    abnormal-input rules."""
    h = h * tx_scaling
    h_norm = h.real ** 2 + h.imag ** 2
    nv = torch.as_tensor(noise_var, device=h.device).to(torch.float32).expand(h_norm.shape)
    valid = _port_validity(h, nv)

    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h_norm = torch.where(valid, h_norm, 0.0)
    ch_mod_sq = torch.sum(h_norm, dim=0)
    nvar_acc = torch.sum(torch.where(valid, h_norm * nv, 0.0), dim=0)
    mf = torch.sum(torch.where(valid, y * torch.conj(h), zero), dim=0)

    ok = (ch_mod_sq > 0) & torch.isfinite(ch_mod_sq)
    d_rcp = torch.where(ok, 1.0 / torch.where(ok, ch_mod_sq, 1.0), 0.0)
    x_hat = torch.where(ok, mf * d_rcp, zero)
    nvar_out = torch.where(ok, nvar_acc * d_rcp * d_rcp, float("inf"))
    return x_hat.to(torch.complex64), nvar_out.to(torch.float32)
