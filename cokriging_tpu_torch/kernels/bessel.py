r"""Modified Bessel function of the second kind :math:`K_\nu(x)` for real
order, in plain torch.

Counterpart of ``cokriging_tpu/kernels/bessel.py`` with the same algorithm
and the same fixed trip counts (Temme 1975, the classic ``bessik``):

- reduce the order to ``mu = nu - round(nu)``, ``|mu| <= 1/2``;
- ``x < 2``: Temme's power series for ``K_mu`` and ``K_{mu+1}``;
- ``x >= 2``: Steed's continued fraction CF2 for ``K_mu``, ``K_{mu+1}``;
- the upward recurrence ``K_{r+1} = (2r/x) K_r + K_{r-1}`` up to ``nu``.

Both branches are evaluated on clamped inputs and selected elementwise.
The JAX package's ``log_precise``/``lgamma_precise`` exist only to work
around the TPU's approximate transcendental units; here ``torch.log`` and
``torch.lgamma`` take their place. The f32 gamma constants keep the
Taylor polynomial ``inv_gamma1p`` (the same values as the reference).

``kv`` is differentiable in both arguments through an
``autograd.Function`` that mirrors the reference's custom JVP: d/dx is the
analytic ``-(K_{nu-1} + K_{nu+1}) / 2`` and d/dnu is the exact derivative
of the same series/CF2 pass with ``nl`` pinned (taken by reverse mode,
which costs less than torch's forward mode here). A first-order backward
reuses the partials of the forward pass; a backward that builds a graph
(``create_graph``: a Hessian) takes them again from that pass kept in the
graph, so K_nu's second derivatives are the derivatives of the same
partials, as in the reference. ``kv_exact_grad`` differentiates the
recurrences directly.

The CUDA counterpart of these loops is ``csrc/kv.cuh``.
"""

import torch

_EULER_GAMMA = 0.5772156649015328606
_ZETA3 = 1.2020569031595942854
_PI = 3.141592653589793238462643383279502884

_A1 = _EULER_GAMMA
_A3 = _EULER_GAMMA**3 / 6.0 - _EULER_GAMMA * _PI**2 / 12.0 + _ZETA3 / 3.0

# Taylor coefficients of 1/Gamma(1+z) (DLMF 5.7.1/5.7.2, shifted); 13 terms
# reach f32 roundoff on |z| <= 0.502.
_INV_GAMMA1P_COEF = (
    1.0000000000000000, 0.5772156649015329, -0.6558780715202538,
    -0.0420026350340952, 0.1665386113822915, -0.0421977345555443,
    -0.0096219715278770, 0.0072189432466630, -0.0011651675918591,
    -0.0002152416741149, 0.0001280502823882, -0.0000201348547807,
    -0.0000012504934821,
)

# Fixed trip counts by dtype (the reference's measured convergence floors:
# cokriging_tpu/kernels/bessel.py:208-209).
SERIES_ITERS = {torch.float64: 40, torch.float32: 12}
CF2_ITERS = {torch.float64: 80, torch.float32: 18}


def inv_gamma1p(z):
    """1/Gamma(1+z) for |z| <= 0.502, by Taylor polynomial."""
    acc = torch.full_like(z, _INV_GAMMA1P_COEF[-1])
    for c in _INV_GAMMA1P_COEF[-2::-1]:
        acc = acc * z + c
    return acc


def dinv_gamma1p(z):
    """d/dz of ``inv_gamma1p``'s Taylor polynomial (exact within it)."""
    n = len(_INV_GAMMA1P_COEF)
    acc = torch.full_like(z, (n - 1) * _INV_GAMMA1P_COEF[-1])
    for k in range(n - 2, 0, -1):
        acc = acc * z + k * _INV_GAMMA1P_COEF[k]
    return acc


def gam12_tangent(mu):
    """d/dmu of ``_gam12``: (dgam1, dgam2, dinv_gp, dinv_gm).

    Feeds the exact forward tangent of dK/dnu through the Temme series in
    the block-gradient kernel. f32 differentiates the Taylor polynomial; f64
    uses d(1/Gamma(1+mu)) = -psi(1+mu)/Gamma(1+mu) and
    d(1/Gamma(1-mu)) = +psi(1-mu)/Gamma(1-mu), as the reference does.
    """
    gam1, _, inv_gp, inv_gm = _gam12(mu)
    if mu.dtype == torch.float32:
        d_gp = dinv_gamma1p(mu)
        d_gm = -dinv_gamma1p(-mu)
    else:
        d_gp = -_Digamma.apply(1.0 + mu) * inv_gp
        d_gm = _Digamma.apply(1.0 - mu) * inv_gm
    d_gam2 = 0.5 * (d_gm + d_gp)
    # quotient rule away from 0; at the removable singularity the odd
    # series d(-(A1 + A3 mu^2)) = -2 A3 mu
    small = torch.abs(mu) < 1e-3
    mu_safe = torch.where(small, 1.0, mu)
    d_gam1 = torch.where(
        small,
        -2.0 * _A3 * mu,
        ((d_gm - d_gp) - 2.0 * gam1) / (2.0 * mu_safe),
    )
    return d_gam1, d_gam2, d_gp, d_gm


def trigamma(x):
    """psi'(x) for x > 0, to float64 round-off: the recurrence psi'(x) =
    psi'(x + 1) + 1/x^2 shifts every lane to x >= 10 in ten branch-free
    steps, then the asymptotic series to x^-15. ``torch.polygamma(1, .)``
    (the derivative torch gives ``digamma``) is off by ~5e-10 relative in
    float64, which a Hessian through lgamma would carry."""
    acc = torch.zeros_like(x)
    for _ in range(10):
        small = x < 10.0
        acc = acc + torch.where(small, 1.0 / (x * x), 0.0)
        x = torch.where(small, x + 1.0, x)
    ix = 1.0 / x
    ix2 = ix * ix
    series = ix2 * (7.0 / 6.0)
    for c in (-691.0 / 2730.0, 5.0 / 66.0, -1.0 / 30.0, 1.0 / 42.0, -1.0 / 30.0, 1.0 / 6.0):
        series = ix2 * (c + series)
    return acc + ix + 0.5 * ix2 + ix * series


class _Digamma(torch.autograd.Function):
    """digamma whose derivative is ``trigamma``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.digamma(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * trigamma(x)


class _Lgamma(torch.autograd.Function):
    """lgamma whose derivative is ``_Digamma``: the same values and first
    derivative as ``torch.lgamma``, and a second derivative to round-off."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.lgamma(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * _Digamma.apply(x)


def lgamma(x):
    """``torch.lgamma`` with second derivatives to float64 round-off."""
    return _Lgamma.apply(x)


def _gam12(mu):
    """(gam1, gam2, 1/Gamma(1+mu), 1/Gamma(1-mu)) for |mu| <= 1/2.

    gam1 = (1/Gamma(1-mu) - 1/Gamma(1+mu)) / (2 mu)   (limit -A1 at mu=0)
    gam2 = (1/Gamma(1-mu) + 1/Gamma(1+mu)) / 2
    f32 uses the Taylor polynomial, f64 exp(-lgamma), as the reference does.
    """
    if mu.dtype == torch.float32:
        inv_gp = inv_gamma1p(mu)
        inv_gm = inv_gamma1p(-mu)
    else:
        inv_gp = torch.exp(-lgamma(1.0 + mu))
        inv_gm = torch.exp(-lgamma(1.0 - mu))
    gam2 = 0.5 * (inv_gm + inv_gp)
    small = torch.abs(mu) < 1e-3
    mu_safe = torch.where(small, 1.0, mu)
    gam1_direct = (inv_gm - inv_gp) / (2.0 * mu_safe)
    gam1_series = -(_A1 + _A3 * mu * mu)
    gam1 = torch.where(small, gam1_series, gam1_direct)
    return gam1, gam2, inv_gp, inv_gm


def _temme_series(mu, x, gam_consts=None):
    """K_mu(x), K_{mu+1}(x) for 0 < x <= 2, |mu| <= 1/2 (Temme's series)."""
    x2 = 0.5 * x
    mu2 = mu * mu
    d = -torch.log(x2)
    e = mu * d
    pimu = _PI * mu

    small_p = torch.abs(pimu) < 1e-4
    fact = torch.where(
        small_p,
        1.0 + pimu * pimu / 6.0,
        pimu / torch.sin(torch.where(small_p, 1.0, pimu)),
    )
    e_exp = torch.exp(e)
    sinh_e = 0.5 * (e_exp - 1.0 / e_exp)
    cosh_e = 0.5 * (e_exp + 1.0 / e_exp)
    small_e = torch.abs(e) < 1e-4
    fact2 = torch.where(
        small_e,
        1.0 + e * e / 6.0,
        sinh_e / torch.where(small_e, 1.0, e),
    )

    if gam_consts is None:
        gam1, gam2, inv_gp, inv_gm = _gam12(mu)
    else:
        gam1, gam2, inv_gp, inv_gm = gam_consts
    ff = fact * (gam1 * cosh_e + gam2 * fact2 * d)
    p = 0.5 * e_exp / inv_gp
    q = 0.5 / (e_exp * inv_gm)
    c = torch.ones_like(x)
    dd = x2 * x2
    ksum = ff
    ksum1 = p
    for i in range(1, SERIES_ITERS[x.dtype] + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu2)
        c = c * dd / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        ksum = ksum + c * ff
        ksum1 = ksum1 + c * (p - fi * ff)
    return ksum, ksum1 * (2.0 / x)


def _steed_cf2(mu, x):
    """K_mu(x), K_{mu+1}(x) for x >= 2, |mu| <= 1/2 (Steed's CF2).

    A lane freezes once |dels/s| < eps (the step that converges is kept).
    Half-integer orders (a1 = 0.25 - mu^2 == 0) never freeze: their
    forward-mode tangents need the full recursion (reference
    cokriging_tpu/kernels/bessel.py:330-340). (q1, q2, c) are renormalized
    every step; only the product c*qnew and the ratio q1:q2 matter.
    """
    mu2 = mu * mu
    a1 = 0.25 - mu2 + 0.0 * x
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    q = a1
    c = a1
    a = -a1
    s = 1.0 + q * delh
    done = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    eps = torch.finfo(x.dtype).eps
    not_degenerate = a1 != 0.0
    for i in range(2, CF2_ITERS[x.dtype] + 2):
        fi = float(i)
        a = a - 2.0 * (fi - 1.0)
        c_n = -a * c / fi
        qnew = (q1 - b * q2) / a
        q = q + c_n * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        dels = q * delh
        s_n = s + dels
        converged = (torch.abs(dels / s_n) < eps) & not_degenerate
        scale = torch.clamp_min(torch.abs(qnew), 1e-30)
        q1 = q2 / scale
        q2 = qnew / scale
        c = c_n * scale
        # Only h and s reach the result, so freezing them freezes the lane;
        # the rest of a frozen lane's state may run on unobserved.
        h = torch.where(done, h, h + delh)
        s = torch.where(done, s, s_n)
        done = done | converged
    h = a1 * h
    k_mu = torch.sqrt(_PI / (2.0 * x)) * torch.exp(-x) / s
    k_mu1 = k_mu * (mu + x + 0.5 - h) / x
    return k_mu, k_mu1


def order_recurrence(mu, nl, x, k_mu, k_mu1):
    """Upward recurrence K_{r+1} = (2r/x) K_r + K_{r-1}, r = mu + i, up to
    order mu + nl (elementwise nl; masked steps keep their lanes)."""
    two_over_x = 2.0 / x
    nl_max = int(torch.max(nl)) if torch.is_tensor(nl) else int(nl)
    for i in range(1, nl_max + 1):
        fi = float(i)
        step = fi <= nl
        k_next = (mu + fi) * two_over_x * k_mu1 + k_mu
        k_mu, k_mu1 = (
            torch.where(step, k_mu1, k_mu),
            torch.where(step, k_next, k_mu1),
        )
    return k_mu, k_mu1


def kv_triple_from_pair(mu, nl, x, k_mu, k_mu1):
    """(K_{nu-1}, K_nu, K_{nu+1}) at nu = mu + nl from one (K_mu, K_{mu+1})
    pair: upward recurrence, with one downward step when nl == 0."""
    km, km1 = order_recurrence(
        mu, torch.clamp_min(nl - 1.0, 0.0), x, k_mu, k_mu1
    )
    nu = mu + nl
    up_next = (2.0 * nu / x) * km1 + km
    dn_prev = km1 - (2.0 * mu / x) * km
    is0 = nl < 0.5
    k_prev = torch.where(is0, dn_prev, km)
    k_mid = torch.where(is0, km, km1)
    k_next = torch.where(is0, km1, up_next)
    return k_prev, k_mid, k_next


def _kv_pair(mu, x):
    """(K_mu, K_{mu+1}) with both branches on clamped inputs, selected at
    x < 2."""
    ks_mu, ks_mu1 = _temme_series(mu, torch.clamp_max(x, 2.0))
    kc_mu, kc_mu1 = _steed_cf2(mu, torch.clamp_min(x, 2.0))
    use_series = x < 2.0
    return (
        torch.where(use_series, ks_mu, kc_mu),
        torch.where(use_series, ks_mu1, kc_mu1),
    )


def _sum_to(g, shape):
    """Reduce a broadcast gradient back to ``shape``."""
    if g.shape == shape:
        return g
    lead = g.ndim - len(shape)
    dims = list(range(lead)) + [
        lead + k for k, n in enumerate(shape) if n == 1 and g.shape[lead + k] != 1
    ]
    return g.sum(dim=dims, keepdim=True).reshape(shape)


def _kv_value(nu, x, with_grads):
    """K_|nu|(x) and, when ``with_grads``, (dK/dnu, dK/dx) on x > 0."""
    nu, x = torch.broadcast_tensors(torch.abs(nu), x)
    pos = x > 0.0
    x_safe = torch.where(pos, x, 1.0)
    nl = torch.floor(nu + 0.5)
    mu = nu - nl
    bad = torch.full_like(x, torch.nan).masked_fill(x == 0.0, torch.inf)
    if not with_grads:
        k_mu, k_mu1 = _kv_pair(mu, x_safe)
        k, _ = order_recurrence(mu, nl, x_safe, k_mu, k_mu1)
        return torch.where(pos, k, bad), None, None
    # one pass gives the value triple and, by differentiating that same
    # pass in mu with nl pinned, the exact dK/dnu (reference _kv_jvp,
    # bessel.py:491-534; every lane depends on its own mu only)
    with torch.enable_grad():
        m = mu.detach().requires_grad_(True)
        k_mu, k_mu1 = _kv_pair(m, x_safe)
        k_prev, k_mid, k_next = kv_triple_from_pair(m, nl, x_safe, k_mu, k_mu1)
        (dk_dnu,) = torch.autograd.grad(k_mid.sum(), m)
    k_prev, k_mid, k_next = k_prev.detach(), k_mid.detach(), k_next.detach()
    dk_dx = -0.5 * (k_prev + k_next)
    return (
        torch.where(pos, k_mid, bad),
        torch.where(pos, dk_dnu, 0.0),
        torch.where(pos, dk_dx, 0.0),
    )


def _kv_partials_graph(nu, x):
    """(dK/dnu, dK/dx) on x > 0 as differentiable functions of ``nu`` and
    ``x``: the partials of ``_kv_value`` from the same series/CF2 pass with
    nl pinned, the pass and its mu-tangent kept in the graph
    (``create_graph``), as the reference's second derivative differentiates
    its custom JVP rule (``_kv_jvp``): dK/dx = -(K_{nu-1} + K_{nu+1}) / 2
    and dK/dnu come out of one pass in (mu, x), and mu = |nu| - nl carries
    |nu|'s sign into their nu-derivatives."""
    nu, x = torch.broadcast_tensors(nu, x)
    nu_abs = torch.abs(nu)
    pos = x > 0.0
    x_safe = torch.where(pos, x, 1.0)
    nl = torch.floor(nu_abs.detach() + 0.5)
    with torch.enable_grad():
        # the tangent is taken against a zero offset of mu, so that it stays
        # a function of nu and x whether or not they require grad
        z = torch.zeros_like(x_safe, requires_grad=True)
        m = nu_abs - nl + z
        k_mu, k_mu1 = _kv_pair(m, x_safe)
        k_prev, k_mid, k_next = kv_triple_from_pair(m, nl, x_safe, k_mu, k_mu1)
        (dk_dnu,) = torch.autograd.grad(k_mid.sum(), z, create_graph=True)
    dk_dx = -0.5 * (k_prev + k_next)
    return torch.where(pos, dk_dnu, 0.0), torch.where(pos, dk_dx, 0.0)


class _Kv(torch.autograd.Function):
    """K_nu(x) with its precomputed first partials. The backward returns
    them when it builds no graph (every fit's gradient: no further pass);
    under ``create_graph`` it rebuilds them as differentiable functions of
    (nu, x) (``_kv_partials_graph``), so a double backward gets the second
    derivatives of K_nu that ``jax.grad(jax.grad(kv))`` gets in the
    reference."""

    @staticmethod
    def forward(ctx, nu, x, k, dk_dnu, dk_dx):
        ctx.save_for_backward(nu, x, dk_dnu, dk_dx)
        return k.clone()

    @staticmethod
    def backward(ctx, grad):
        nu, x, dk_dnu, dk_dx = ctx.saved_tensors
        if torch.is_grad_enabled():
            dk_dnu, dk_dx = _kv_partials_graph(nu, x)
        g_nu = _sum_to(grad * dk_dnu, nu.shape) if ctx.needs_input_grad[0] else None
        g_x = _sum_to(grad * dk_dx, x.shape) if ctx.needs_input_grad[1] else None
        return g_nu, g_x, None, None, None


def _promote(nu, x):
    """(nu, x) as tensors of one float dtype (at least float32) on one
    device."""
    nu = torch.as_tensor(nu)
    x = torch.as_tensor(x)
    dtype = torch.promote_types(torch.promote_types(nu.dtype, x.dtype), torch.float32)
    device = x.device if (x.ndim or not nu.ndim) else nu.device
    return nu.to(device=device, dtype=dtype), x.to(device=device, dtype=dtype)


def kv(nu, x):
    r"""Modified Bessel function of the second kind, :math:`K_\nu(x)`.

    Matches ``scipy.special.kv`` on ``x > 0``, ``0 < |nu| <= 30``;
    ``x == 0`` gives ``inf`` and ``x < 0`` gives ``nan``, like scipy.
    Differentiable in both arguments, to any order (see the module
    docstring).
    """
    nu, x = _promote(nu, x)
    needs = torch.is_grad_enabled() and (nu.requires_grad or x.requires_grad)
    with torch.no_grad():
        k, dk_dnu, dk_dx = _kv_value(nu, x, needs)
    if not needs:
        return k
    return _Kv.apply(nu, x, k, dk_dnu, dk_dx)


def kv_ratio(nu, x):
    """K_{nu+1}(x) / K_nu(x) (reference ``kv_ratio``, bessel.py:537-539)."""
    return kv(nu + 1.0, x) / kv(nu, x)


def kv_exact_grad(nu, x):
    """K_|nu|(x) differentiated by plain autograd straight through the
    series/CF2 pass and the order recurrence (reference ``kv_exact_grad``,
    bessel.py:542-554). Domain: x > 0, with no scipy-style edge values."""
    nu, x = _promote(nu, x)
    nu, x = torch.broadcast_tensors(torch.abs(nu), x)
    nl = torch.floor(nu + 0.5)
    mu = nu - nl
    k_mu, k_mu1 = _kv_pair(mu, x)
    return order_recurrence(mu, nl, x, k_mu, k_mu1)[0]
