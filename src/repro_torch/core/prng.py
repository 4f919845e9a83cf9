"""``jax.random``'s Threefry streams on tensors: the keys, splits and draws
that the JAX package's sweep consumes, bit for bit.

The installed jax draws with ``threefry2x32`` in its partitionable mode
(``jax_threefry_partitionable``): a draw of shape s from key k is the hash
of k with the row-major flat index of each entry as a 64-bit counter.  So
any slice of a draw can be computed by itself, from its counters alone —
what lets a rank of a sharded sweep draw only its own rows and clients.

A key is a ``[..., 2]`` int32 tensor (the two uint32 words) on the caller's
device.  Every function takes a batch of keys (any leading shape) and
returns a batch of draws ``[..., *shape]``; none reads a key back to the
host.  The hashing is ``kernels/ops.threefry``: the hand-written kernel
(kernels/csrc/threefry.cu) on the card, its plain version on the CPU.

Counterparts (jax -> here): ``PRNGKey`` -> :func:`prng_key`, ``split`` ->
:func:`split`, ``fold_in`` -> :func:`fold_in`, ``random_bits`` (32-bit) ->
:func:`random_bits`, ``uniform``, ``normal`` (float32), ``randint``
(int32), ``permutation`` of ``arange(n)`` (with ``lax.sort_key_val``
for its sorts).  ``uniform`` and the integer draws are bitwise jax's;
``normal`` goes through the port's float32 ``erfinv`` (sim/truncnorm.py),
within 2 ulp of XLA's, so within 3 ulp after the multiply by sqrt(2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import int32_of, uint32_of
from repro_torch.sim.truncnorm import SQRT2, erfinv

_MASK = 0xFFFFFFFF
# the open lower end of normal's uniforms: nextafter(-1, 0) in float32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _keys(key: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    if key.dtype != torch.int32 or key.shape[-1:] != (2,):
        raise ValueError(f"a key is a [..., 2] int32 tensor, got "
                         f"{key.dtype} {tuple(key.shape)}")
    return key.reshape(-1, 2), tuple(key.shape[:-1])


def _size(shape) -> tuple[tuple[int, ...], int]:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return shape, math.prod(shape)


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` (``threefry_seed``) of an integer seed, or of
    a tensor of seeds: [..., 2] int32.

    A 64-bit seed splits into its (high, low) words, a 32-bit one is padded
    with a zero high word.  Python ints and int32 tensors are 32-bit seeds,
    taken modulo 2^32 (a negative seed wraps: -1 -> (0, 0xFFFFFFFF)), as
    the installed jax, with 64-bit types off, converts them; int64 tensors
    are 64-bit seeds."""
    if not isinstance(seed, torch.Tensor):
        lo = torch.as_tensor(np.asarray(seed, np.int64) & _MASK,
                             device=device)
        hi = torch.zeros_like(lo)
    elif seed.dtype == torch.int32:
        lo = uint32_of(seed)
        hi = torch.zeros_like(lo)
    elif seed.dtype == torch.int64:
        hi, lo = (seed >> 32) & _MASK, seed & _MASK
    else:
        raise ValueError(f"seeds must be int32 or int64, got {seed.dtype}")
    return int32_of(torch.stack([hi, lo], -1))


def split(key: torch.Tensor, num: int = 2, offset: int = 0) -> torch.Tensor:
    """``jax.random.split`` (its fold-like form): [..., 2] keys ->
    [..., num, 2].  With ``offset``, keys offset .. offset + num - 1 of a
    split into any larger number (``split(k, n)[a:b]`` = ``split(k, b - a,
    offset=a)``)."""
    flat, lead = _keys(key)
    return ops.threefry(flat, num, offset=offset, out="pairs").reshape(
        *lead, num, 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of ``key`` with the counter (0,
    data).  ``data``: an int, or an int tensor broadcastable against
    ``key[..., 0]`` (the hierarchical round's cell ids on the device);
    taken modulo 2^32.  Returns [broadcast shape, 2]."""
    if not isinstance(data, torch.Tensor):
        flat, lead = _keys(key)
        return ops.threefry(flat, 1, offset=int(data) & _MASK,
                            out="pairs").reshape(*lead, 2)
    lead = torch.broadcast_shapes(key.shape[:-1], data.shape)
    flat = key.expand(*lead, 2).reshape(-1, 2)
    rows = data.expand(lead).reshape(-1).long() & _MASK
    return ops.threefry(flat, 1, row_offsets=rows, out="pairs").reshape(
        *lead, 2)


def random_bits(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits`` with 32 bits: [..., *shape] int32 (the uint32
    bits).  ``offset``: start at that flat index, for a slice of a larger
    draw (entries offset .. offset + prod(shape) - 1 of its row-major
    order)."""
    shape, n = _size(shape)
    flat, lead = _keys(key)
    return ops.threefry(flat, max(n, 1), offset=offset, out="bits")[
        :, :n].reshape(lead + shape)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval): [..., *shape].
    ``offset`` as in :func:`random_bits`."""
    shape, n = _size(shape)
    flat, lead = _keys(key)
    return ops.threefry(flat, max(n, 1), offset=offset, out="uniform",
                        minval=minval, maxval=maxval)[:, :n].reshape(
                            lead + shape)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    return SQRT2 * erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` in int32 on [minval, maxval), for Python-int
    bounds inside the int32 range: two 32-bit draws from the key's two
    halves, combined modulo the span with uint32 wrap-around, as jax
    combines them."""
    shape, _ = _size(shape)
    b = uint32_of(random_bits(split(key, 2), shape))     # one launch
    hi, lo = b.select(key.dim() - 1, 0), b.select(key.dim() - 1, 1)
    span = max(int(maxval) - int(minval), 1)
    mult = ((1 << 16) % span) ** 2 % (1 << 32) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return (int(minval) + off % span).to(torch.int32)


def shuffle_rounds(n: int) -> int:
    """Sorting rounds of jax's ``_shuffle`` for n entries:
    ceil(3 ln n / ln(2^32 - 1)) — one up to n = 1625, two from 1626."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def shuffle_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """The sort keys' keys of ``permutation(key, n)``: [..., rounds, 2].
    Each round splits the running key into (next key, subkey)."""
    subs = []
    for _ in range(shuffle_rounds(n)):
        pair = split(key, 2)
        key = pair[..., 0, :]
        subs.append(pair[..., 1, :])
    return torch.stack(subs, -2)


def sort_key_val(keys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``lax.sort_key_val(keys, x)[1]`` along the last axis for int32
    ``keys`` holding uint32 words: ``x`` in the keys' unsigned order,
    stably (tied keys keep the order they came in, as
    ``lax.sort_key_val``'s default ``is_stable=True`` does)."""
    order = torch.sort(uint32_of(keys), dim=-1, stable=True).indices
    return x.gather(-1, order)


def permute(subkeys: torch.Tensor, n: int) -> torch.Tensor:
    """``permutation`` from its :func:`shuffle_keys`: [..., n] int64, each
    round sorting by fresh 32-bit draws (:func:`sort_key_val`)."""
    lead = subkeys.shape[:-2]
    x = torch.arange(n, device=subkeys.device).expand(*lead, n)
    for i in range(subkeys.shape[-2]):
        x = sort_key_val(random_bits(subkeys[..., i, :], (n,)), x)
    return x


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of arange(n),
    [..., n] int64."""
    return permute(shuffle_keys(key, n), n)
