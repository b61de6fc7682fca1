"""PRNG helpers.

The reference seeds its iterations with ``Vector::Random`` (uniform in
[-1, 1]; complex entries have uniform real and imaginary parts) at
power_method.hpp:62. Here start vectors come from an explicit
``torch.Generator``, seeded with a fixed default so results repeat run to
run. The numbers differ from the JAX package's ``jax.random`` draws; pass
the same ``x0`` to both where they must agree.
"""

from __future__ import annotations

import torch

from ..core.dtypes import as_torch_dtype, real_dtype_of

DEFAULT_SEED = 0


def default_generator(device=None) -> torch.Generator:
    """A generator on ``device`` seeded with ``DEFAULT_SEED``."""
    return torch.Generator(device=device or "cpu").manual_seed(DEFAULT_SEED)


def random_unit_vector(generator: torch.Generator, n: int, dtype, device=None):
    """Uniform [-1,1] entries (re/im for complex), normalised to unit 2-norm.

    Drawn on the generator's device, returned on ``device`` (default: the
    generator's)."""
    dt = as_torch_dtype(dtype)
    rdt = real_dtype_of(dt)

    def uniform():
        return torch.rand(n, generator=generator, dtype=rdt,
                          device=generator.device) * 2 - 1

    x = torch.complex(uniform(), uniform()) if dt.is_complex else uniform()
    x = x.to(device=device or generator.device)
    nrm = torch.linalg.vector_norm(x)
    return torch.where(nrm == 0, x, x / torch.where(nrm == 0, 1, nrm).to(dt))
