"""JAX's threefry random stream in plain PyTorch.

The counterpart of the pieces of ``jax.random`` that the reference's
sampler draws from (``jax._src.prng`` and ``jax._src.random``, with
``jax_threefry_partitionable`` on, JAX 0.9's default):

- :func:`prng_key` — ``threefry_seed``: an int32 seed as the key words
  (seed >> 32, seed & 0xFFFFFFFF), so a negative seed keeps its two's
  complement bits;
- :func:`threefry2x32` — the Threefry-2x32 hash, 20 rounds;
- :func:`random_bits` — the partitionable layout: the flat index of each
  element split into (hi, lo) counter words, the draw ``bits1 ^ bits2``;
- :func:`split` — ``jax.random.split``: key ``i`` is the pair of words
  threefry gives for the counters of index ``i``;
- :func:`fold_in` — ``jax.random.fold_in``: the two words threefry
  gives for the counters (0, data);
- :func:`randint` — ``jax.random.randint`` for int32: two draws of
  bits from the split key, folded into the span;
- :func:`uniform`, :func:`gumbel`, :func:`categorical`;
- :func:`normal` — ``jax.random.normal``: ``sqrt(2) * erfinv(u)`` of a
  uniform over (-1, 1).

Every value is bitwise what JAX computes on the CPU. The integer steps
are exact; uint32 values are held in int64 (torch's uint32 lacks most
arithmetic on the CPU) and wrapped with ``& MASK32``. The one float
function on the way, ``log`` in the Gumbel transform, is XLA:CPU's and
not a correctly rounded one: :func:`xla_log` repeats its Cephes
polynomial with the same fused multiply-adds, so the Gumbel noise is
bitwise JAX's too. ``normal``'s ``erfinv`` (:func:`xla_erfinv`) repeats
XLA's float32 polynomial (Giles' single-precision erfinv, its Horner
steps as fused multiply-adds) over ``-log1p(-x^2)``, where ``log1p``
(:func:`xla_log1p`) is XLA:CPU's: :func:`xla_log` of ``1 + x`` from
|x| = sqrt(2) - 1 up, Cephes' rational form below, and the square root
of the tail branch is correctly rounded (torch's float32 CPU ``sqrt``
is not always). So the normal draws are bitwise JAX's as well.
``csrc/fused_sample.cu`` repeats these steps on the
card (its threefry stream). The JAX package is not imported: every
constant is written out here.
"""

import torch

MASK32 = 0xFFFFFFFF
TINY = 1.1754943508222875e-38            # float32's smallest normal

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA                     # Threefry's key-schedule constant

# the Cephes log polynomial of XLA:CPU's vectorised ``log`` (float32)
_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375


def prng_key(seed, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data for an int32 seed (an int
    or a 0-d integer tensor): int64 [2] holding the uint32 words
    (0, seed & 0xFFFFFFFF). Raises for a seed outside int32, as JAX does
    without 64-bit mode."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is outside int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under ``key``
    (int64 [2] of uint32 words): 5 groups of 4 rounds, a key injection
    after each. Returns the two output words, int64 holding uint32."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32), partitionable layout:
    element ``i`` of the flattened shape hashes the counters
    (i >> 32, i & 0xFFFFFFFF) and draws the xor of the two words.
    int64 holding uint32, of ``shape``, on ``device`` (default: the
    key's; a key kept on the host draws on the card with no sync)."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64,
                       device=device if device is not None else key.device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK32)
    return (b0 ^ b1).reshape(tuple(shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` under the partitionable threefry:
    new key ``i`` is the two output words of the counters
    (i >> 32, i & 0xFFFFFFFF), not their xor. int64 [num, 2] holding
    uint32 words, on the key's device."""
    idx = torch.arange(int(num), dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK32)
    return torch.stack([b0, b1], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a non-negative int32
    ``data``: the two output words of threefry on the counters
    (0, data). int64 [2] holding uint32 words, on the key's device."""
    d = torch.tensor([int(data) & MASK32], dtype=torch.int64,
                     device=key.device)
    b0, b1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.cat([b0, b1])


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, scalar
    bounds): the higher and lower bits come from the two keys of
    ``split(key)``; with ``span = maxval - minval`` (1 when empty) the
    offset is ``((hi % span) * m + lo % span) % span`` in uint32
    arithmetic, ``m = (2**16 % span)**2 % span``. int64 holding the
    int32 values, on ``device`` (default: the key's)."""
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2) % span
    off = (((hi % span) * mult) & MASK32) + lo % span
    return minval + (off & MASK32) % span


def uniform(key: torch.Tensor, shape, minval: float = TINY,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of each draw
    as the mantissa of a float in [1, 2), minus 1, scaled to
    [minval, maxval) and clamped below at ``minval`` (the Gumbel
    transform's defaults)."""
    bits = random_bits(key, shape, device)
    one = (bits >> 9) | 0x3F800000
    f = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add
    (``b`` and ``c`` float32 tensors or numbers taken as float32): the
    product of two floats is exact in float64, the sum is rounded to
    odd in float64 (its error from ``TwoSum``), and rounding that to
    float32 is then correct, since float64 carries more than 24 + 1
    bits. A number becomes a device fill, not a copy from the host (which
    would wait for the device)."""
    b, c = ((v.to(a.device, torch.float32) if isinstance(v, torch.Tensor)
             else torch.full((), v, dtype=torch.float32, device=a.device))
            .double() for v in (b, c))
    p = a.double() * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    s = torch.where(inexact, torch.nextafter(s, toward), s)
    return s.float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` as XLA:CPU computes it, for positive, finite, normal
    float32 ``x``: Cephes' logf (mantissa in [sqrt(1/2), sqrt(2)), a
    degree-8 polynomial) with the polynomial's steps and the
    exponent's low-order term as fused multiply-adds. Bitwise equal to
    JAX's on every input of the Gumbel transform."""
    x = x.float()
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < torch.tensor(_SQRTHF, dtype=torch.float32)
    e = e - small.float()
    t = (m - 1.0) + torch.where(small, m, 0.0)
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = fma32(t, p[0], p[1])
    y1 = fma32(t, p[3], p[4])
    y2 = fma32(t, p[6], p[7])
    y = fma32(y, t, p[2])
    y1 = fma32(y1, t, p[5])
    y2 = fma32(y2, t, p[8])
    y = fma32(y, t3, y1)
    y = fma32(y, t3, y2)
    y = fma32(y, t3, e * _LOG_Q1)
    t = t - t2 * 0.5
    t = t + y
    return t + e * _LOG_Q2


# Giles' float32 erfinv ("Approximating the erfinv function", GPU Computing
# Gems), as XLA's ErfInv32: w < 5 and w >= 5 coefficient sets, highest
# degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_LOG1P_SMALL = 0.41421356237309504880      # sqrt(2) - 1
# Cephes' log1p rational form below sqrt(2) - 1, XLA:CPU's small branch:
# numerator and denominator, highest degree first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of float32 ``x`` in (-1, 0], as XLA:CPU computes it:
    ``xla_log(1 + x)`` where |x| >= sqrt(2) - 1; below it Cephes' rational
    form ``x - x^2/2 + x^3 * P(x) / Q(x)``, each polynomial by Horner's
    rule from 0 in float32 fused multiply-adds."""
    x = x.float()
    near = x.abs() < _LOG1P_SMALL
    large = xla_log(torch.where(near, torch.ones_like(x), x + 1.0))
    num = torch.zeros_like(x)
    for c in _LOG1P_P:
        num = fma32(num, x, c)
    den = torch.zeros_like(x)
    for c in _LOG1P_Q:
        den = fma32(den, x, c)
    x2 = x * x
    small = x + ((-0.5) * x2 + (x * x2) * (num / den))
    return torch.where(near, small, large)


def xla_erfinv(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.erfinv`` of float32 ``x`` in (-1, 1), as XLA
    computes it: ``w = -log1p(-x^2)``; for ``w < 5`` a degree-8
    polynomial in ``w - 2.5``, else in ``sqrt(w) - 3``; times ``x``."""
    x = x.float()
    w = -xla_log1p(-(x * x))
    lt = w < 5.0
    # float32 sqrt correctly rounded, as XLA's: torch's vectorised CPU
    # float32 sqrt is an ulp off at times, the float64 root rounded once
    # is exact
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma32(p, w, coef(i))
    return p * x


def normal(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erfinv(u)`` with ``u`` :func:`uniform` over (nextafter(-1, 0), 1),
    on ``device`` (default: the key's)."""
    lo = -0.99999994039535522461            # nextafter(-1, 0) in float32
    u = uniform(key, shape, lo, 1.0, device=device)
    return 1.41421353816986083984 * xla_erfinv(u)


def gumbel(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel`` (``mode="low"``): ``-log(-log(u))`` of
    :func:`uniform` over [float32 tiny, 1), on ``device`` (default: the
    key's)."""
    return -xla_log(-xla_log(uniform(key, shape, device=device)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the first-index
    argmax of Gumbel noise of ``logits``' shape plus the logits, drawn
    on the logits' device."""
    g = gumbel(key, logits.shape, device=logits.device)
    return torch.argmax(g + logits.float(), dim=-1)
