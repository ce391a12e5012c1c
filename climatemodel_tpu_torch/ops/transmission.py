"""Band optical depth, transmission functions and flux-integral weights for
the real-gas solver (port of ``climatemodel_tpu/ops/transmission.py``).

The reference's per-band Python loops (real_gas.py:86-184, 564-669 of the
NumPy original) become batched tensor contractions over *packed band
structures*:

  * every wavenumber band is padded to a common width with zero trapz
    weights, so all-band reductions are single contractions;
  * the nz x nz transmission matrices are built only for long-wave bands,
    with the exp argument clamped at 0 — every element the flux equations
    read has tau(p1) <= tau(p2), and the clamp keeps the unread triangle
    finite so zero-weight masking cannot create inf * 0 = NaN in float32;
    they are built a chunk of bands at a time, so the [L, nz, nz, K]
    exponent never exists whole (nz = 400 in float64 on the card, and the
    tests on the CPU);
  * the reference's per-level trapz with moving integration limits becomes
    two precomputed weight matrices W_up/W_down — the limits depend only on
    the static pressure grid.

The grids, tau and the weights are host NumPy float64, bit-equal to the JAX
package; the attenuation and transmission functions are torch on the
device of their ``tau``.
"""
from __future__ import annotations

import numpy as np
import torch

#: bytes of the [bands, nz, nz, K] exponent built at once by
#: :func:`band_transmission_matrices`
TRANSMISSION_CHUNK_BYTES = 1 << 28


# --------------------------------------------------------------------------
# optical depth (real_gas.py:86-127)
# --------------------------------------------------------------------------

def optical_depth(p, T, wavenumber, molecule_names, q_funcs, q_funcs_args,
                  absorption_lookup, g):
    """tau(p, nu) = integral_0^p k q / g dp', cumulative trapz from p = 0.

    :param p: [np] ascending pressures (the integration grid).
    :param T: [np] temperatures at those pressures.
    :param absorption_lookup: callable (p, T, wavenumber, molecule_name) ->
        [np x n_nu] nearest-neighbour absorption coefficients.
    :return: tau [np x n_nu]; tau[-1] is the surface value.
    """
    p = np.sort(np.asarray(p, dtype=np.float64))
    integrand = np.zeros((p.size, np.size(wavenumber)))
    for name in molecule_names:
        k = absorption_lookup(p, T, wavenumber, name)
        q = np.asarray(q_funcs[name](p, *q_funcs_args[name]))
        integrand += k * q.reshape(-1, 1)
    integrand /= g
    # prepend the (p=0, integrand=0) point (real_gas.py:122-124)
    dp = np.diff(np.concatenate(([0.0], p)))
    avg = 0.5 * (np.concatenate((np.zeros((1, integrand.shape[1])), integrand))[:-1]
                 + integrand)
    return np.cumsum(avg * dp[:, None], axis=0)


def nearest_lookup(p, T, nu, table):
    """Nearest-neighbour absorption-coefficient lookup in (p, T, nu)
    (real_gas.py:45-62)."""
    p_ind = np.abs(np.asarray(p).reshape(-1, 1) - table['p'][None]).argmin(axis=1)
    T_ind = np.abs(np.asarray(T).reshape(-1, 1) - table['T'][None]).argmin(axis=1)
    nu_ind = np.abs(np.asarray(nu).reshape(-1, 1) - table['nu'][None]).argmin(axis=1)
    return table['absorption_coef'][p_ind, T_ind][:, nu_ind]


def crop_lookup(p, T, wavenumber, table):
    """Lookup restricted to the table's wavenumber coverage, zero outside
    (real_gas.py:65-83)."""
    out = np.zeros((np.size(p), np.size(wavenumber)))
    inside = np.where((wavenumber >= table['nu'].min())
                      & (wavenumber <= table['nu'].max()))[0]
    if inside.size:
        out[:, inside] = nearest_lookup(p, T, wavenumber[inside], table)
    return out


# --------------------------------------------------------------------------
# packed band structures (host-side, static shapes)
# --------------------------------------------------------------------------


def _trapz_weights(xs):
    """Trapezoid quadrature weights over nodes xs: sum(w*y) = trapz(y, xs)."""
    wt = np.zeros(xs.size)
    if xs.size > 1:
        d = np.diff(xs)
        wt[:-1] += 0.5 * d
        wt[1:] += 0.5 * d
    return wt

class PackedBands:
    """Static arrays describing the wavenumber bands for fused device ops.

    idx [n_bands, K]     indices into the full nu grid (padded with 0)
    w   [n_bands, K]     trapz weights over the band's nu range (0 on padding)
    delta [n_bands]      band widths (real_gas.py 'delta')
    centre [n_bands]     band-centre wavenumbers
    sw  [n_bands] bool   True if no atmospheric emission integral needed
    lw_list [n_lw]       indices of the long-wave (sw == False) bands
    """

    def __init__(self, bands, nu):
        nu = np.asarray(nu)
        n_bands = len(bands['range'])
        K = max(len(r) for r in bands['range'])
        self.idx = np.zeros((n_bands, K), dtype=np.int32)
        self.w = np.zeros((n_bands, K))
        for b, rng in enumerate(bands['range']):
            ind = np.searchsorted(nu, rng)
            self.idx[b, :len(rng)] = ind
            # trapezoid weights over the band's own nu values
            self.w[b, :len(rng)] = _trapz_weights(np.asarray(rng, float))
        self.delta = np.asarray(bands['delta'], dtype=np.float64)
        self.centre = np.asarray(bands['centre'], dtype=np.float64)
        self.sw = np.asarray(bands['sw'], dtype=bool)
        self.lw_list = np.where(~self.sw)[0]
        # long-wave sub-packing (tight width for the nz x nz matrices)
        if self.lw_list.size:
            K_lw = max(len(bands['range'][b]) for b in self.lw_list)
            self.lw_idx = self.idx[self.lw_list, :K_lw]
            self.lw_w = self.w[self.lw_list, :K_lw]
            self.lw_delta = self.delta[self.lw_list]
            self.lw_centre = self.centre[self.lw_list]
        else:
            self.lw_idx = np.zeros((0, 1), np.int32)
            self.lw_w = np.zeros((0, 1))
            self.lw_delta = np.zeros((0,))
            self.lw_centre = np.zeros((0,))


def flux_integral_weights(p_interface, p_centre):
    """Precompute the per-level trapz weight matrices of the reference's
    moving-limit integrals (real_gas.py:581-626).

    Integration nodes for interface level i (ascending pressure, index 0 = TOA):

      up  (i <= nz-2):  x = [p_int[i], p_c[i..nz-2], p_int[nz-1]]
                        y = [B(T_int[i]) dTr[i,i], B(T[m]) dTr[i,m],
                             B(T_g) dTr[i,nz-2]]
      down (j >= 1):    x = [p_int[0], p_c[0..j-1], p_int[j]]
                        y = [B(T_int[0]) dTr[0,j], B(T[m]) dTr[m,j],
                             B(T_int[j]) dTr[j-1,j]]

    Returns (W_up, W_down), each [nz, nz+1]: column 0 is the interface-end
    node, columns 1..nz-1 the cell-centre nodes, column nz the far-end node.
    Rows with no integral (up: i = nz-1; down: j = 0) are all zero.
    """
    p_int = np.asarray(p_interface, dtype=np.float64)
    p_c = np.asarray(p_centre, dtype=np.float64)
    nz = p_int.size
    W_up = np.zeros((nz, nz + 1))
    W_down = np.zeros((nz, nz + 1))
    for i in range(nz - 1):
        xs = np.concatenate(([p_int[i]], p_c[i:], [p_int[-1]]))
        wt = _trapz_weights(xs)
        W_up[i, 0] = wt[0]
        W_up[i, 1 + i: nz] = wt[1:-1]
        W_up[i, nz] = wt[-1]
    for j in range(1, nz):
        xs = np.concatenate(([p_int[0]], p_c[:j], [p_int[j]]))
        wt = _trapz_weights(xs)
        W_down[j, 0] = wt[0]
        W_down[j, 1: 1 + j] = wt[1:-1]
        W_down[j, nz] = wt[-1]
    return W_up, W_down


# --------------------------------------------------------------------------
# device ops
# --------------------------------------------------------------------------

def band_attenuation(tau, idx, w, delta, ref_level):
    """Transmission between every interface and a fixed reference interface
    for all bands at once: Tr[b, i] = (1/delta_b) sum_k w[b,k]
    exp(-|tau[i,k] - tau[ref,k]|).

    The exact exponent is tau(smaller-p side) - tau(larger-p side), which is
    always <= 0 for both uses — the surface-flux decay exp(tau_i -
    tau_surface) (ref_level = surface) and the TOA-flux decay exp(tau_toa -
    tau_j) (ref_level = 0) of real_gas.py:645-655 — so -|dtau| reproduces
    both and is overflow-free.

    :param tau: [nz, n_nu] tensor; ``idx`` [B, K] int64, ``w`` [B, K] and
        ``delta`` [B] tensors on its device.
    :return: [B, nz]
    """
    tau_b = tau[:, idx]                                    # [nz, B, K]
    e = torch.exp(-torch.abs(tau_b - tau_b[ref_level][None]))
    return (e * w[None]).sum(-1).T / delta[:, None]


def band_transmission_matrices(tau, idx, w, delta,
                               chunk_bytes=TRANSMISSION_CHUNK_BYTES):
    """Full nz x nz transmission matrices for the (long-wave) bands:
    Tr[b, i, j] = (1/delta_b) sum_k w[b,k] exp(min(tau[i,k] - tau[j,k], 0)).

    The clamp preserves every element read by the flux integrals (those all
    have tau_i <= tau_j) and keeps the unread triangle finite.  Bands are
    taken ``chunk_bytes`` of exponent at a time; each band's sum over k is
    the same whatever the chunk.

    :return: [L, nz, nz]
    """
    tau_b = tau[:, idx].movedim(1, 0)                      # [L, nz, K]
    L, nz, K = tau_b.shape
    per_band = max(1, nz * nz * K * tau_b.element_size())
    step = max(1, int(chunk_bytes) // per_band)
    out = torch.empty((L, nz, nz), dtype=tau_b.dtype, device=tau_b.device)
    for s in range(0, L, step):
        t = tau_b[s:s + step]
        e = (t[:, :, None, :] - t[:, None, :, :]).clamp_(max=0.0).exp_()
        out[s:s + step] = e.mul_(w[s:s + step, None, None, :]).sum(-1)
    return out / delta[:, None, None]


def dtransmission_dq(p1, p2, tau_band, w, delta, absorption_band, g):
    """Rate of change of band transmission with absorber concentration
    (real_gas.py:157-184), for the greenhouse-activity diagnostics; NumPy
    or torch.

    :param tau_band: [2, K] tau at the two levels over the band's nu values.
    :param absorption_band: [K] absorption spectrum over the band.
    """
    if torch.is_tensor(tau_band):
        expo = torch.clamp(tau_band[0] - tau_band[1], max=0.0)
        e = torch.exp(expo)
    else:
        e = np.exp(np.minimum(tau_band[0] - tau_band[1], 0.0))
    integrand = (p1 - p2) * absorption_band * e / g
    return (integrand * w).sum() / delta
