"""Random sampling ops (port of ``paddle_tpu/ops/random.py``).

Every draw comes from the current device's ``default_generator`` (reset by
``paddle_tpu_torch.seed``), never from torch's global RNG; the streams are
torch's, not JAX's, so a seed gives other numbers than the JAX package's
with the same distribution, shape and dtype.  In-place fills rebind the
Tensor to a new tensor, as the JAX ``_set_data``."""

from __future__ import annotations

import torch

from ..framework.device import default_device
from ..framework.dtype import convert_dtype
from ..framework.random import default_generator
from ..framework.tensor import Tensor
from .common import apply, data_of
from .creation import _dt, _shape

__all__ = [
    "uniform", "uniform_", "normal", "normal_", "standard_normal", "randn", "rand",
    "randint", "randint_like", "randperm", "bernoulli", "bernoulli_", "multinomial",
    "poisson", "exponential_", "standard_gamma", "log_normal", "log_normal_", "cauchy_",
    "geometric_", "binomial",
]


def _gen(dev=None):
    dev = default_device() if dev is None else dev
    return dev, default_generator(dev)


def _fill(x: Tensor, t: torch.Tensor) -> Tensor:
    x._data = t.to(x.dtype)
    return x


def _uniform(shape, dtype, lo, hi, dev=None):
    dev, g = _gen(dev)
    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(dtype)


def _normal(shape, dev=None):
    dev, g = _gen(dev)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    return Tensor._wrap(_uniform(_shape(shape), _dt(dtype), min, max))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    d = data_of(x)
    return _fill(x, _uniform(d.shape, d.dtype, min, max, d.device))


def normal(mean=0.0, std=1.0, shape=None, dtype=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = data_of(mean) if isinstance(mean, Tensor) else torch.tensor(mean, dtype=torch.float32)
        s = data_of(std) if isinstance(std, Tensor) else torch.tensor(std, dtype=torch.float32)
        dev = (m if isinstance(mean, Tensor) else s).device
        m, s = m.to(dev), s.to(dev)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        return Tensor._wrap(m + s * _normal(shp, dev))
    shp = _shape(shape) if shape is not None else ()
    return Tensor._wrap((mean + std * _normal(shp)).to(_dt(dtype)))


def normal_(x, mean=0.0, std=1.0, name=None):
    d = data_of(x)
    return _fill(x, mean + std * _normal(d.shape, d.device))


def standard_normal(shape, dtype=None, name=None):
    return Tensor._wrap(_normal(_shape(shape)).to(_dt(dtype)))


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    d = convert_dtype(dtype)
    if d == torch.int64:
        d = torch.int32
    dev, g = _gen()
    return Tensor._wrap(torch.randint(low, high, _shape(shape), generator=g, device=dev,
                                      dtype=d))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, tuple(data_of(x).shape), dtype or "int32")


def randperm(n, dtype="int64", name=None):
    d = convert_dtype(dtype)
    if d == torch.int64:
        d = torch.int32
    dev, g = _gen()
    return Tensor._wrap(torch.randperm(n, generator=g, device=dev).to(d))


def bernoulli(x, p=None, name=None):
    d = data_of(x)
    probs = d.to(torch.float32) if p is None else torch.full(d.shape, float(p), device=d.device)
    _, g = _gen(d.device)
    return Tensor._wrap(torch.bernoulli(probs, generator=g).to(d.dtype))


def bernoulli_(x, p=0.5, name=None):
    d = data_of(x)
    _, g = _gen(d.device)
    return _fill(x, torch.bernoulli(torch.full(d.shape, float(p), device=d.device), generator=g))


def multinomial(x, num_samples=1, replacement=False, name=None):
    probs = data_of(x).to(torch.float32)
    _, g = _gen(probs.device)
    out = torch.multinomial(probs, num_samples, replacement=replacement, generator=g)
    return Tensor._wrap(out.to(torch.int32))


def poisson(x, name=None):
    d = data_of(x)
    _, g = _gen(d.device)
    return Tensor._wrap(torch.poisson(d.to(torch.float32), generator=g).to(d.dtype))


def exponential_(x, lam=1.0, name=None):
    d = data_of(x)
    u = _uniform(d.shape, torch.float32, 0.0, 1.0, d.device)
    return _fill(x, -torch.log1p(-u) / lam)


def standard_gamma(alpha, name=None):
    a = data_of(alpha).to(torch.float32)
    _, g = _gen(a.device)
    # torch._standard_gamma takes no generator: draw through Gamma's
    # Marsaglia-Tsang rejection on the default generator's normals and
    # uniforms instead of torch's global RNG
    return Tensor._wrap(_gamma(a, g))


def _gamma(alpha: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    done = torch.zeros_like(a, dtype=torch.bool)
    while not bool(done.all()):
        z = torch.randn(a.shape, generator=g, device=a.device)
        u = torch.rand(a.shape, generator=g, device=a.device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-30)) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        take = ok & ~done
        out = torch.where(take, d * v, out)
        done = done | ok
    u = torch.rand(a.shape, generator=g, device=a.device)
    return torch.where(boost, out * u.clamp_min(1e-30) ** (1.0 / alpha), out)


def log_normal(mean=1.0, std=2.0, shape=None, dtype=None, name=None):
    shp = _shape(shape) if shape is not None else ()
    return Tensor._wrap(torch.exp(mean + std * _normal(shp)).to(_dt(dtype)))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    d = data_of(x)
    return _fill(x, torch.exp(mean + std * _normal(d.shape, d.device)))


def cauchy_(x, loc=0, scale=1, name=None):
    d = data_of(x)
    u = _uniform(d.shape, torch.float32, 0.0, 1.0, d.device)
    return _fill(x, loc + scale * torch.tan(torch.pi * (u - 0.5)))


def geometric_(x, probs, name=None):
    d = data_of(x)
    u = _uniform(d.shape, torch.float32, 1e-7, 1.0, d.device)
    return _fill(x, torch.ceil(torch.log(u) / torch.log1p(torch.tensor(-probs))))


def binomial(count, prob, name=None):
    def f(n, p):
        _, g = _gen(n.device)
        # n Bernoulli trials a sample: exact for the counts the namespace takes
        trials = int(n.max()) if n.numel() else 0
        u = torch.rand(n.shape + (trials,), generator=g, device=n.device)
        k = torch.arange(trials, device=n.device)
        hit = (u < p.to(torch.float32)[..., None]) & (k < n[..., None])
        return hit.sum(-1).to(torch.int32)

    return apply("binomial", f, count if isinstance(count, (Tensor, torch.Tensor))
                 else Tensor(count), prob if isinstance(prob, (Tensor, torch.Tensor))
                 else Tensor(prob))
