"""JAX's random numbers and flax's init keys, with neither jax nor flax.

The JAX package draws everything random from ``jax.random`` (threefry2x32,
the default PRNG) and, inside ``Module.init``, from flax's key folding. So
that ``seed: s`` means the same run in the port, every draw of the port
comes from here, computed to JAX's bits:

- keys: ``PRNGKey(seed)``, ``split``, ``fold_in`` (jax/_src/prng.py:
  ``threefry_seed``, ``threefry_2x32``, ``_threefry_split_foldlike``,
  ``threefry_fold_in``);
- ``random_bits`` in the partitionable layout (``jax_threefry_partitionable``,
  on by default since JAX 0.5): element i hashes the counter pair
  (i >> 32, i & 0xffffffff) and XORs the two output words;
- ``uniform`` (jax/_src/random.py ``_uniform``: 23 mantissa bits under
  exponent 0, minus 1, scaled, clamped below at minval, all in f32);
- ``normal``: sqrt(2) * erf_inv(u), u uniform on (-1, 1), with XLA's f32
  erf_inv polynomial (stablehlo's ``materializeErfInvF32``). Only its
  log1p is the host's: a draw may differ from JAX's by a few ulps;
- ``permutation(key, n)`` (``_shuffle``): ceil(3 ln n / ln(2^32 - 1))
  rounds, each splitting the key and stably sorting by 32 random bits;
- flax's ``LazyRng`` folding (flax/core/scope.py ``_fold_in_static``, with
  ``flax_fix_rng_separator`` off, its default): the key a module's
  ``make_rng`` gives is ``fold_in(root, first 4 bytes of SHA-1(path names
  + call counter))``; ``models/factory.init_params`` builds the JAX
  package's ``init_model`` variables from it with ``xavier_uniform`` and
  ``rff_projection``.

Keys are ``Key`` values, JAX's uint32[2] key data. The draws return numpy
arrays, or with ``device=`` torch tensors computed on that device (int32
lanes holding the uint32 words; the same bits), for the draws that are
large or repeated: the eigensolvers' start blocks, the pretraining's
sphere samples and a per-epoch permutation of every record.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_UINT32_MAX_LOG = np.log(np.iinfo(np.uint32).max)
# XLA's f32 erf_inv: p(w) for w = -log1p(-x^2) < 5 (at w - 2.5), else at sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


@dataclass(frozen=True)
class Key:
    """A threefry2x32 key: the two uint32 words of ``jax.random.PRNGKey``'s data."""
    hi: int
    lo: int

    @classmethod
    def of(cls, data):
        """The key of JAX key data (a uint32[2] array, e.g. a checkpoint's rng_key)."""
        a = np.asarray(data).reshape(-1)
        if a.shape != (2,):
            raise ValueError(f"a threefry key is two uint32 words, got shape {np.shape(data)}")
        return cls(int(a[0]) & _M32, int(a[1]) & _M32)

    @property
    def data(self):
        return np.array([self.hi, self.lo], np.uint32)


def PRNGKey(seed):
    """``jax.random.PRNGKey(seed)`` (64-bit ints off, as the JAX package runs):
    the words (0, seed mod 2^32)."""
    return Key(0, int(seed) & _M32)


def _schedule(key):
    """threefry2x32's key injections under `key`: the words added to the
    two counter words before the rounds, then after each group of four
    (6 pairs, uint32 values)."""
    ks = (key.hi, key.lo, key.hi ^ key.lo ^ _PARITY)
    out = [ks[0], ks[1]]
    for i in range(5):
        out += [ks[(i + 1) % 3], (ks[(i + 2) % 3] + i + 1) & _M32]
    return out


def _threefry(key, x0, x1, wrap=lambda a: a & _M32):
    """threefry2x32 (20 rounds) of the counter words (x0, x1) under `key`:
    uint32 numpy arrays (``wrap`` the identity), or Python ints (``wrap``
    masks to 32 bits)."""
    s = _schedule(key)
    x0, x1 = wrap(x0 + s[0]), wrap(x1 + s[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = x0 ^ (wrap(x1 << r) | (x1 >> (32 - r)))
        x0, x1 = wrap(x0 + s[2 + 2 * i]), wrap(x1 + s[3 + 2 * i])
    return x0, x1


def _hash_np(key, x0, x1):
    return _threefry(key, np.asarray(x0, np.uint32), np.asarray(x1, np.uint32), lambda a: a)


def _bits_torch(keys, size, device):
    """random_bits of `size` elements under each of `keys` at once, on
    `device`: an int32 tensor [len(keys), size] whose lanes hold the uint32
    bits. int32 lanes wrap as uint32 arithmetic does; a logical right shift
    is the arithmetic one masked. One pass over every key's lanes, in
    place: 6 elementwise launches per threefry round."""
    if size >= 2 ** 31:
        raise ValueError(f"{size} draws: at most 2^31 - 1 in one call on a device")
    i32 = lambda v: v - (1 << 32) if v >= 1 << 31 else v  # noqa: E731  (the same bits)
    sched = torch.tensor([[i32(v) for v in _schedule(k)] for k in keys], dtype=torch.int32,
                         device=device)
    x1 = torch.arange(size, dtype=torch.int32, device=device) + sched[:, 1:2]
    x0 = sched[:, 0:1].expand_as(x1).clone()  # the counters' high words are 0
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            torch.bitwise_right_shift(x1, 32 - r, out=t)
            t &= (1 << r) - 1
            x1 <<= r
            x1 |= t
            x1 ^= x0
        x0 += sched[:, 2 + 2 * i:3 + 2 * i]
        x1 += sched[:, 3 + 2 * i:4 + 2 * i]
    x0 ^= x1
    return x0


def split(key, num=2):
    """``jax.random.split(key, num)`` as a list of keys: key i is the hash
    of the counter (0, i)."""
    return [Key(*_threefry(key, 0, i)) for i in range(num)]


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data)."""
    return Key(*_threefry(key, 0, int(data) & _M32))


def _size(shape):
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 2 ** 32:
        raise ValueError(f"{size} draws: at most 2^32 - 1 in one call")
    return shape, size


def random_bits(key, shape, device=None):
    """32 random bits per element of `shape`, ``jax.random.bits(key, shape,
    uint32)``: element i hashes the counter (0, i) and XORs the two output
    words. A uint32 numpy array, or an int64 tensor on `device`."""
    shape, size = _size(shape)
    if device is None:
        b0, b1 = _hash_np(key, np.zeros(size, np.uint32), np.arange(size, dtype=np.uint32))
        return (b0 ^ b1).reshape(shape)
    return (_bits_torch([key], size, device)[0].to(torch.int64) & _M32).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0, device=None):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    if device is None:
        bits = random_bits(key, shape)
        floats = ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
        return np.maximum(lo, _fma(floats, hi - lo, lo, np))
    shape, size = _size(shape)
    bits = _bits_torch([key], size, device)[0].reshape(shape)
    floats = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    return torch.clamp_min(_fma(floats, float(hi - lo), float(lo), torch), float(lo))


def _fma(a, b, c, xp):
    """f32 a * b + c rounded once, as XLA's CPU backend contracts a multiply
    feeding an add: the product is exact in f64, the sum rounds to f64 and
    then to f32, and where that sum lands exactly halfway between two f32
    values the error-free remainder of the f64 sum picks the side."""
    f64 = np.float64 if xp is np else torch.float64
    p = a.astype(f64) * b if xp is np else a.to(f64) * b
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)  # s + e == p + c exactly
    bits = s.view(np.uint64) if xp is np else s.view(torch.int64)
    half = (bits & ((1 << 29) - 1)) == (1 << 28)
    inf = xp.full_like(s, np.inf)
    s = xp.where(half & (e != 0), xp.nextafter(s, xp.where(e > 0, inf, -inf)), s)
    return s.astype(np.float32) if xp is np else s.to(torch.float32)


def _erf_inv(x, xp):
    """XLA's f32 erf_inv of x in (-1, 1) (numpy or torch, by `xp`)."""
    w = -xp.log1p(x * -x)
    lt = w < 5
    w = xp.where(lt, w - 2.5, xp.sqrt(w) - 3.0)

    def coef(i):
        a, b = np.float32(_ERFINV_LT5[i]), np.float32(_ERFINV_GE5[i])
        if xp is np:
            return np.where(lt, a, b)
        return torch.where(lt, torch.tensor(float(a), device=x.device),
                           torch.tensor(float(b), device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i), xp)
    return p * x


def normal(key, shape, device=None):
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erf_inv(u), u
    uniform on [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0, device)
    if device is None:
        return np.float32(np.sqrt(2)) * _erf_inv(u, np)
    return float(np.float32(np.sqrt(2))) * _erf_inv(u, torch)


def permutation(key, n, device=None):
    """``jax.random.permutation(key, n)``: int64 numpy array, or an int64
    tensor on `device` (every round's bits drawn in one pass)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / _UINT32_MAX_LOG))
    subs = []
    for _ in range(rounds):
        key, sub = split(key)
        subs.append(sub)
    if device is None:
        x = np.arange(n, dtype=np.int64)
        for sub in subs:
            x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
        return x
    x = torch.arange(n, dtype=torch.int64, device=device)
    if subs:
        bits = _bits_torch(subs, n, device)
        bits ^= -2 ** 31  # the uint32 order as the int32 order
        for b in bits:
            x = x[torch.sort(b, stable=True).indices]
    return x


# --------------------------------------------------------------------- flax


def flax_key(root, *path):
    """The key flax's ``make_rng`` gives under the init key `root`: `path`
    is the module path's names, then the scope's call counter (1 for the
    first draw of that stream in that module: a Dense's kernel; 2 its bias)."""
    if not path:
        return root
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def xavier_uniform(key, fan_in, fan_out):
    """flax's ``nn.initializers.xavier_uniform()`` kernel [fan_in, fan_out]:
    uniform on [-1, 1) times sqrt(3 * f32(2 / (fan_in + fan_out)))."""
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, (fan_in, fan_out), -1.0, 1.0) * np.sqrt(np.float32(3) * variance)


def xavier_uniform_gain(key, fan_in, fan_out, gain=1.0):
    """The NeuTex networks' kernel init (JAX models/neutex.py:58-64):
    uniform on +-gain * sqrt(6 / (fan_in + fan_out)), the limit rounded to f32."""
    limit = gain * np.sqrt(6.0 / (fan_in + fan_out))
    return uniform(key, (fan_in, fan_out), -limit, limit)


def rff_projection(buffers_key, k, std=1.0, in_dim=3, scope=()):
    """The B [in_dim, k] a RandomFourierFeatEnc at module path `scope` draws
    in an init whose "buffers" key is `buffers_key` (JAX
    models/encoders.py:58-63)."""
    return np.float32(std) * normal(flax_key(buffers_key, *scope, 1), (in_dim, k))
