"""Dry convective adjustment as a batched column operator (port of
``climatemodel_tpu/ops/convection.py``).

The reference enforces stability dtheta/dz >= 0 with a serial groupby/while
algorithm: each unstable run of levels is replaced by the enthalpy-conserving
blend of two flattened candidate profiles ('lower' anchored just above the
run, 'upper' anchored at its base), iterating until stable, and skipping any
group whose adjustment exceeds ``delta_T_thresh``
(convective_adjustment.py:36-118 of the NumPy original).

Columns are rows of a [C, n] tensor (p descending, surface first); the JAX
package's ``vmap`` over columns is that leading axis here.

``method='reference'`` (default) — the faithful group-blend iteration.  The
    JAX package runs it as nested ``lax.while_loop``s under ``vmap``, so
    each column's result depends on that column alone.  CPU tensors take one
    lock-step loop over the batch: outer sweeps continue while any column
    is active (unstable, progressing, under ``max_outer``), the group loop
    runs to the largest group count of the active columns, and a column
    with fewer groups sees an empty group and is left unchanged — exactly
    what the vmapped loops' selects do.  Columns with no unstable level are
    untouched (the JAX package's stability gate).  CUDA tensors take the
    ``group_blend`` kernel (ops/csrc/convection.cu, K8): a warp per column,
    each column looping on its own, one launch and no host sync a call.
    It replaces no Pallas kernel (the JAX package's was retired in r05
    after miscompiling on the chip, ``climatemodel_tpu/ops/convection.py:
    211-217``); its plain twin :func:`group_blend_plain` is the lock-step
    loop with the kernel's order of the enthalpy sums
    (:func:`warp_row_sums`).

``method='isotonic'`` — the closed form: the stable enthalpy-conserving
    profile of maximal mixing is the weighted isotonic regression of
    theta = T / pi with weights v = w pi, evaluated by the min-max formula

        theta'_i = max_{s<=i} min_{t>=i} (SV[t+1] - SV[s]) / (SW[t+1] - SW[s])

    from prefix sums SV (of v theta) and SW (of v).  The prefix sums follow
    one rule on every device (:func:`iso_prefix_sums`: a sequential double
    sum, rounded to the dtype at each entry), because the fit amplifies
    their rounding by sum(v) / min(v).  CUDA tensors take the ``iso_fit``
    kernel (ops/csrc/convection.cu, the Pallas ``_iso_kernel`` with its
    prefix sums), which forms the sums itself; CPU tensors take
    :func:`iso_rows_plain` (the sums, then :func:`iso_fit_plain`).
"""
from __future__ import annotations

import torch

from ..constants import g, c_p_dry, p_surface_earth, R_specific
from ..utils import timing

_SMALL = 1e-10   # instability tolerance (convective_adjustment.py:62)

#: f32(9.81 / 1004.64), the folded g/c_p-like constant of the division probe
DIV_PROBE_C = 9.81 / 1004.64


def _instability_tol(theta):
    """Per-level instability tolerance for theta-diffs of [..., n] rows.

    In f64 it is exactly the reference's 1e-10.  Below f64 the round trip
    theta = T / pi -> T = theta * pi leaves ~1 ulp of noise on high-theta
    levels, which a fixed 1e-10 would read as instability, so the tolerance
    is max(1e-10, 16 eps max(|theta_i|, |theta_{i+1}|)), the last value
    repeated (the JAX package's rule)."""
    eps = torch.finfo(theta.dtype).eps
    small = torch.tensor(_SMALL, dtype=theta.dtype, device=theta.device)
    if eps < 1e-12:                              # f64: reference constant
        return small.expand(theta.shape)
    mag = torch.maximum(theta[..., :-1].abs(), theta[..., 1:].abs())
    tol = torch.maximum(small, (16 * eps) * mag)
    return torch.cat([tol, tol[..., -1:]], dim=-1)


def _trapz_weights(p):
    """Weights w with sum(w * T) = -trapz(T, p) for descending p
    (convective_adjustment.py:133-135): the two half-widths added in the JAX
    package's order."""
    dp = p[:-1] - p[1:]                          # positive for descending p
    w = torch.zeros_like(p)
    w[:-1] = w[:-1] + 0.5 * dp
    w[1:] = w[1:] + 0.5 * dp
    return w


def grid_factors(p, lapse_rate=g / c_p_dry, p_reference=p_surface_earth):
    """(pi, w) of a descending [n] pressure column: the Exner-like factor
    pi = (p / p_ref)^alpha, alpha = R lapse_rate / g, in p's dtype, and the
    enthalpy weights."""
    alpha = R_specific * lapse_rate / g
    return (p / p_reference) ** alpha, _trapz_weights(p)


def median_last(x):
    """Median over the last axis as ``jnp.median`` computes it: the two middle
    order statistics, (lo + hi) * 0.5 (``torch.median`` would return the
    lower one for an even count); a row holding NaN gives NaN."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    lo, hi = s[..., (n - 1) // 2], s[..., n // 2]
    med = (lo + hi) * 0.5
    return torch.where(torch.isnan(x).any(dim=-1), float('nan'), med)


# --------------------------------------------------------------------------
# method='reference': faithful group-blend iteration
# --------------------------------------------------------------------------

def _unstable_mask(T, pi, ignored):
    theta = T / pi                               # T / pi, never T * (1 / pi)
    d = theta[:, 1:] - theta[:, :-1]
    d_ext = torch.cat([d, d[:, -1:]], dim=1)     # duplicated last diff (:60-61)
    return (d_ext < -_instability_tol(theta)) & ~ignored


def _group_step(T, ignored, gid, gi, pi, w, thresh, idx, live, row_sums):
    """One group of one sweep for every column (convective_adjustment.py:
    64-110); ``live`` [C] marks the columns whose loops are still running;
    ``row_sums`` sums the enthalpy products of each row."""
    n = T.shape[1]
    in_g = gid == gi
    any_g = in_g.any(dim=1)
    theta = T / pi
    # first / last index of the group (argmax of a bool row in the JAX
    # package: 0 and n-1 for an empty group, which is masked out below)
    grp_first = torch.where(any_g, torch.where(in_g, idx, n).amin(dim=1), 0)
    grp_last = torch.where(any_g, torch.where(in_g, idx, -1).amax(dim=1),
                           n - 1)
    # 'lower' candidate: flatten [start .. lo_anchor] at theta[lo_anchor]
    lo_anchor = torch.clamp(grp_last + 1, max=n - 1)
    theta_lo = torch.gather(theta, 1, lo_anchor[:, None])
    low_mask = (theta < theta_lo) & (idx < lo_anchor[:, None])
    start = torch.where(low_mask.any(dim=1),
                        torch.where(low_mask, idx, -1).amax(dim=1) + 1, 0)
    T_lower = torch.where((idx >= start[:, None]) & (idx <= lo_anchor[:, None]),
                          theta_lo * pi, T)
    # 'upper' candidate: flatten [hi_anchor .. stop] at theta[hi_anchor]
    hi_anchor = grp_first
    theta_hi = torch.gather(theta, 1, hi_anchor[:, None])
    hi_mask = (theta > theta_hi) & (idx > hi_anchor[:, None])
    stop = torch.where(hi_mask.any(dim=1),
                       torch.where(hi_mask, idx, n - 1).amin(dim=1), n - 1)
    T_upper = torch.where((idx >= hi_anchor[:, None]) & (idx <= stop[:, None]),
                          theta_hi * pi, T)
    # enthalpy-conserving blend (convective_adjustment.py:102-105)
    H = row_sums(w * T)
    H_lo = row_sums(w * T_lower)
    H_hi = row_sums(w * T_upper)
    denom = H_hi - H_lo
    zero = denom == 0
    beta = torch.where(zero, 0.5, (H - H_lo) / torch.where(zero, 1.0, denom))
    T_new = beta[:, None] * T_upper + (1 - beta[:, None]) * T_lower
    accept = (T_new - T).abs().amax(dim=1) < thresh
    take = live & any_g
    T = torch.where((take & accept)[:, None], T_new, T)
    ignored = ignored | (in_g & (take & ~accept)[:, None])
    return T, ignored


def _torch_row_sums(x):
    return x.sum(dim=1)


#: lanes of a warp, over which the ``group_blend`` kernel strides a
#: column's levels
WARP = 32


def warp_row_sums(x):
    """Row sums of [C, n] in the ``group_blend`` kernel's order: lane l of
    a warp adds levels l, l + 32, l + 64, ... in turn to a zero (0 past the
    row's end), then the 32 partial sums meet in a butterfly (partner lane
    l ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1).  Each butterfly step adds two values
    that every pair of partners adds alike, so every lane ends with the
    same sum."""
    C, n = x.shape
    k = -(-n // WARP)
    lanes = torch.zeros((C, k * WARP), dtype=x.dtype, device=x.device)
    lanes[:, :n] = x
    lanes = lanes.reshape(C, k, WARP)
    acc = torch.zeros((C, WARP), dtype=x.dtype, device=x.device)
    for j in range(k):
        acc = acc + lanes[:, j]
    lane = torch.arange(WARP, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    return acc[:, 0]


def _lockstep_blend(T, pi, w, thresh, max_groups, max_outer, row_sums):
    """The group blend of [C, n] columns as one lock-step loop over the
    batch: one host sync per outer sweep reads the largest group count of
    the active columns (0 ends the loop); the counter ``blend.sweeps``
    counts them, the span ``blend.sync`` times them."""
    C, n = T.shape
    idx = torch.arange(n, device=T.device)
    thresh = thresh.to(T.dtype)
    ignored = torch.zeros_like(T, dtype=torch.bool)
    progressed = torch.ones((C,), dtype=torch.bool, device=T.device)
    un = _unstable_mask(T, pi, ignored)
    sweep = 0
    while sweep < max_outer:
        active = un.any(dim=1) & progressed
        starts = un & ~torch.cat([torch.zeros_like(un[:, :1]), un[:, :-1]], 1)
        gid = torch.where(un, torch.cumsum(starts, dim=1), 0)   # frozen per sweep
        n_groups = torch.clamp(gid.amax(dim=1), max=max_groups)
        timing.count('blend.sweeps')
        with timing.span('blend.sync'):
            n_run = int(torch.where(active, n_groups, 0).amax())
        if n_run == 0:
            break
        T_prev = T
        for gi in range(1, n_run + 1):
            T, ignored = _group_step(T, ignored, gid, gi, pi, w, thresh, idx,
                                     active & (gi <= n_groups), row_sums)
        un_new = _unstable_mask(T, pi, ignored)
        progressed = torch.where(
            active, (T != T_prev).any(dim=1) | (un_new != un).any(dim=1),
            progressed)
        un = un_new
        sweep += 1
    return T


def _blend_limits(n, max_groups, max_outer):
    return (n // 2 + 1 if max_groups is None else max_groups,
            4 * n if max_outer is None else max_outer)


@timing.spanned('blend')
def reference_adjust_rows(T, pi, w, thresh, max_groups=None, max_outer=None):
    """Faithful group-blend adjustment of [C, n] columns (p descending) on a
    shared grid (pi, w [n]) with per-column thresholds ``thresh`` [C]; at
    most ``max_groups`` groups a sweep (default n // 2 + 1) and
    ``max_outer`` sweeps (default 4 n) a column.

    CPU tensors take the lock-step loop (:func:`_lockstep_blend`, a host
    sync a sweep); every other device the ``group_blend`` kernel (one
    launch, counted by ``blend.launches``; it raises where it cannot
    launch)."""
    max_groups, max_outer = _blend_limits(T.shape[1], max_groups, max_outer)
    if T.device.type == 'cpu':
        return _lockstep_blend(T, pi, w, thresh, max_groups, max_outer,
                               _torch_row_sums)
    from .cuda_convection import group_blend
    return group_blend(T, pi, w, thresh, max_groups, max_outer)


def group_blend_plain(T, pi, w, thresh, max_groups=None, max_outer=None):
    """Plain PyTorch version of the ``group_blend`` kernel (K8) on any
    device: the lock-step loop with the kernel's enthalpy sums
    (:func:`warp_row_sums`).  Every other operation rounds alike in both,
    so on the CPU it gives the kernel's result bit for bit."""
    max_groups, max_outer = _blend_limits(T.shape[1], max_groups, max_outer)
    return _lockstep_blend(T, pi, w, thresh, max_groups, max_outer,
                           warp_row_sums)


# --------------------------------------------------------------------------
# method='isotonic': min-max weighted PAVA
# --------------------------------------------------------------------------

def iso_fit_plain(SV, SW):
    """Plain PyTorch version of the ``iso_fit`` kernel (K4).

    :param SV: [n+1, b] per-column prefix sums of v * theta (row 0 zero).
    :param SW: [n+1] shared prefix sums of v (row 0 zero).
    :return: [n, b] with out[t] = max_{s<=t} min_{t'>=t} avg(s, t'),
        avg(s, t') = (SV[t'+1] - SV[s]) / (SW[t'+1] - SW[s]) — the same
        subtractions and division per entry as the kernel; min and max are
        exact, so their order does not change the result.  Entries with
        s > t are +inf in the min and -inf in the max.  NaN propagates.
    """
    n1, b = SV.shape
    n = n1 - 1
    num = SV[None, 1:, :] - SV[:n, None, :]             # [s, t, b]
    den = (SW[None, 1:] - SW[:n, None])[:, :, None]     # [s, t, 1]
    s_le_t = torch.ones((n, n), dtype=torch.bool, device=SV.device).triu()
    avg = torch.where(s_le_t[:, :, None], num / den, float('inf'))
    # M[s, t] = min over t' >= t (a suffix minimum along t)
    M = torch.flip(torch.cummin(torch.flip(avg, [1]), dim=1).values, [1])
    M = torch.where(s_le_t[:, :, None], M, float('-inf'))
    return torch.diagonal(torch.cummax(M, dim=0).values).T.contiguous()


def iso_prefix_sums(theta, v):
    """(SV [n+1, C], SW [n+1]) of [C, n] rows with shared weights v [n], by
    the rule the ``iso_fit`` kernel follows: v * theta rounded in the
    dtype, then a sequential sum in double with each partial sum rounded to
    the dtype (row 0 zero).  Exact on the CPU, where ``torch.cumsum`` sums
    in order (a CUDA scan would round otherwise)."""
    C, n = theta.shape
    zero = torch.zeros((1, C), dtype=theta.dtype, device=theta.device)
    SV = torch.cumsum(v * theta, dim=1, dtype=torch.float64).to(theta.dtype)
    SW = torch.cumsum(v, dim=0, dtype=torch.float64).to(theta.dtype)
    return torch.cat([zero, SV.T]), torch.cat([zero[0, :1], SW])


def iso_rows_plain(theta, v):
    """Plain PyTorch version of the ``iso_fit`` kernel (K4): the [C, n]
    isotonic fits of [C, n] rows with shared weights v [n],
    :func:`iso_prefix_sums` then :func:`iso_fit_plain`."""
    return iso_fit_plain(*iso_prefix_sums(theta, v)).T


def _iso_rows(theta, v):
    """[C, n] weighted non-decreasing isotonic fits with shared weights v
    [n].  CPU tensors take :func:`iso_rows_plain`, CUDA tensors the
    ``iso_fit`` kernel (which raises where it cannot launch)."""
    if theta.device.type == 'cpu':
        return iso_rows_plain(theta, v)
    from .cuda_convection import iso_fit
    return iso_fit(theta, v)


def _segment_abs_max(dT, changed):
    """max|dT| over each connected run of ``changed`` along the last axis of
    [C, n], broadcast back onto the run's positions (0 elsewhere).  The JAX
    package uses segmented scans to avoid a scatter on the TPU; on the GPU
    an exact ``scatter_reduce('amax')`` over segment ids is the same
    maximum."""
    x = torch.where(changed, dT.abs(), torch.zeros_like(dT))
    starts = changed & ~torch.cat([torch.zeros_like(changed[:, :1]),
                                   changed[:, :-1]], dim=1)
    seg = torch.where(changed, torch.cumsum(starts, dim=1), 0)
    seg_max = torch.zeros((dT.shape[0], dT.shape[1] + 1), dtype=dT.dtype,
                          device=dT.device).scatter_reduce(
        1, seg, x, reduce='amax', include_self=True)
    return torch.where(changed, torch.gather(seg_max, 1, seg), 0.0)


def isotonic_adjust_rows(T, pi, w, thresh):
    """Isotonic adjustment of [C, n] columns (p descending) with per-column
    thresholds [C]: connected changed regions whose adjustment is too large
    are reverted (the reference's group-skip rule,
    convective_adjustment.py:106-110)."""
    theta = T / pi
    T_new = _iso_rows(theta, w * pi) * pi
    dT = T_new - T
    changed = dT.abs() > 1e-12
    keep = changed & (_segment_abs_max(dT, changed)
                      < thresh.to(T.dtype)[:, None])
    return torch.where(keep, T_new, T)


def adjust_rows(T, pi, w, thresh, method='reference'):
    """Adjust [C, n] columns on a prepared grid (pi, w) with per-column
    thresholds [C]."""
    if method == 'reference':
        return reference_adjust_rows(T, pi, w, thresh)
    if method == 'isotonic':
        return isotonic_adjust_rows(T, pi, w, thresh)
    raise ValueError(f'unknown method {method!r}')


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def convective_adjustment_single(p, T, lapse_rate=g / c_p_dry,
                                 delta_T_thresh=None,
                                 p_reference=p_surface_earth,
                                 method='reference'):
    """Adjust one column (p descending, surface first) to convective
    stability dT/dz >= -lapse_rate, conserving enthalpy -integral(T dp)."""
    return convective_adjustment(p, T, lapse_rate, delta_T_thresh,
                                 p_reference, method, descending=True)


def convective_adjustment(p, T, lapse_rate=g / c_p_dry, delta_T_thresh=None,
                          p_reference=p_surface_earth, method='reference',
                          descending=None):
    """Convective adjustment of every column.

    :param p: [nz] pressures (ascending or descending, auto-flipped like
        convective_adjustment.py:19-27).
    :param T: [nz], [nz, ny], or [B, nz, ny] (a batch of such grids)
        temperatures.
    :param delta_T_thresh: largest adjustment accepted; None -> median(T)/4
        per column (convective_adjustment.py:55-56).
    :param descending: the grid orientation; None -> read it from p (one
        host sync).
    :return: adjusted temperatures, same shape as T.
    """
    shape = T.shape
    if T.ndim == 1:
        Tb = T[None, :, None]
    elif T.ndim == 2:
        Tb = T[None]
    else:
        Tb = T
    if descending is None:
        descending = bool(p[0] > p[1])
    if not descending:
        p = torch.flip(p, [0])
        Tb = torch.flip(Tb, [1])
    B, nz, ny = Tb.shape
    rows = Tb.permute(0, 2, 1).reshape(B * ny, nz)
    pi, w = grid_factors(p, lapse_rate, p_reference)
    thresh = (median_last(rows) / 4.0 if delta_T_thresh is None else
              torch.full((B * ny,), float(delta_T_thresh), dtype=T.dtype,
                         device=T.device))
    out = adjust_rows(rows, pi, w, thresh, method)
    out = out.reshape(B, ny, nz).permute(0, 2, 1)
    if not descending:
        out = torch.flip(out, [1])
    return out.reshape(shape).contiguous()


def get_theta(T, p, p_reference=p_surface_earth, alpha=R_specific / c_p_dry):
    """Potential temperature (convective_adjustment.py:125-126)."""
    return T / (p / p_reference) ** alpha


def get_enthalpy(T, p):
    """Column enthalpy ~ -trapz(T, p) (convective_adjustment.py:133-135)."""
    return -torch.trapezoid(T, p, dim=0)


# --------------------------------------------------------------------------
# the division probe (K7): plain version
# --------------------------------------------------------------------------

def div_probe_plain(a, b):
    """Plain PyTorch version of the ``div_probe`` kernel (K7): a / b,
    (C * a) / b and a / |b| with C = f32(9.81 / 1004.64), in f32."""
    C = torch.tensor(DIV_PROBE_C, dtype=torch.float32, device=a.device)
    return a / b, C * a / b, a / torch.abs(b)


#: elements of one warp's chunk in the ``div_probe`` kernel: 32 lanes x 4
DIV_PROBE_WARP_ELEMENTS = 128
#: ``in_fast_range`` (ops/csrc/div_rn.cuh): |x| in [2^-20, 2^40]
FAST_RANGE = (2.0 ** -20, 2.0 ** 40)


def _fast_operands(num, den):
    """Where the kernel may divide ``num / den`` with ``div_rn_in_range``:
    the denominator in range, and the numerator in range or +0 over a
    positive denominator."""
    lo, hi = FAST_RANGE

    def in_range(x):
        return (x.abs() >= lo) & (x.abs() <= hi)
    pos_zero = (num == 0) & ~torch.signbit(num)
    return in_range(den) & (in_range(num) | (pos_zero & (den > 0)))


def div_probe_warp_paths(a, b):
    """How many warps of the ``div_probe`` kernel (K7) divide each quotient
    with ``div_rn_in_range`` ('fast') and how many with ``/`` ('div_rn'),
    for f32 inputs ``a``, ``b`` of one shape.  A warp holds 128 consecutive
    elements of the flattened inputs (the last chunk padded with 1 / 1) and
    takes the fast form only where every one of its operands allows it; the
    numerator of (C * a) / b is the rounded product C * a.

    :return: ``{'a_div_b': {'fast': n, 'div_rn': m}, 'c_mul_a_div_b':
        {...}, 'a_div_abs_b': {...}}``.
    """
    a, b = a.reshape(-1), b.reshape(-1)
    C = torch.tensor(DIV_PROBE_C, dtype=torch.float32, device=a.device)
    oks = {'a_div_b': _fast_operands(a, b),
           'c_mul_a_div_b': _fast_operands(C * a, b),
           'a_div_abs_b': _fast_operands(a, torch.abs(b))}
    chunks = -(-a.numel() // DIV_PROBE_WARP_ELEMENTS)
    pad = chunks * DIV_PROBE_WARP_ELEMENTS - a.numel()
    res = {}
    for name, ok in oks.items():
        ok = torch.cat([ok, ok.new_ones(pad)]).reshape(chunks,
                                                     DIV_PROBE_WARP_ELEMENTS)
        fast = int(ok.all(dim=1).sum())
        res[name] = {'fast': fast, 'div_rn': chunks - fast}
    return res


def div_probe(a, b):
    """The division probe (K7) on f32 tensors of one shape: the plain
    version for CPU tensors, the ``div_probe`` kernel for CUDA tensors."""
    if a.device.type == 'cpu':
        return div_probe_plain(a, b)
    from .cuda_convection import div_probe as kernel
    return kernel(a, b)
