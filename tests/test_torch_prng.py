"""gsjax_torch.utils.prng against jax.random on the CPU, bit for bit: keys
(``PRNGKey``, ``split``, ``fold_in``), bits, uniforms and normals, and the
float32 ``erf_inv`` (XLA's, with its log1p and log) on which the normals
rest. gsjax sets no PRNG flag, so JAX's defaults are what the port
reproduces; the first test fails loudly if a JAX upgrade changes them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gsjax_torch.utils import prng

SEEDS = [0, 1, 2**31 - 1, 7, 42, 123456789]
SHAPES = [(3,), (0,), (1,), (1001,), (2, 1000, 3)]


def _bits_of(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_same_floats(got: torch.Tensor, want):
    """Bit for bit (NaNs of either sign and payload count as equal)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    both_nan = np.isnan(got) & np.isnan(want)
    off = (_bits_of(got) != _bits_of(want)) & ~both_nan
    assert not off.any(), (f"{int(off.sum())} of {off.size} differ, e.g. "
                           f"{got[off][:4]} against {want[off][:4]}")


def test_jax_defaults_are_what_the_port_reproduces():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS + [-1, 2**32 + 5])
def test_keys_match_jax(seed):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert k.dtype == np.uint32 and k.shape == (2,)
    np.testing.assert_array_equal(k, np.asarray(jk))
    for num in (2, 1, 5, 17):
        np.testing.assert_array_equal(prng.split(k, num), np.asarray(jax.random.split(jk, num)))
    a, b = prng.split(k)  # the loop's ``key, k = split(key)``
    ja, jb = jax.random.split(jk)
    np.testing.assert_array_equal(a, np.asarray(ja))
    np.testing.assert_array_equal(b, np.asarray(jb))
    for data in (0, 1, 3, 299, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(k, data),
                                      np.asarray(jax.random.fold_in(jk, data)))
    # a chain of the loop's and train_multiscene's kind
    chain, jchain = k, jk
    for it in range(5):
        chain, jchain = prng.split(chain)[0], jax.random.split(jchain)[0]
        chain, jchain = prng.fold_in(chain, it), jax.random.fold_in(jchain, it)
    np.testing.assert_array_equal(chain, np.asarray(jchain))


def test_fold_in_refuses_what_is_not_a_uint32():
    with pytest.raises(ValueError, match="uint32"):
        prng.fold_in(prng.PRNGKey(0), -1)
    with pytest.raises(ValueError, match="two uint32 words"):
        prng.bits(np.zeros(3, np.uint32), (2,), "cpu")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_match_jax(seed, shape):
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.bits(k, shape, "cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.bits(jk, shape)))
    _assert_same_floats(prng.uniform(k, shape, "cpu"), jax.random.uniform(jk, shape))
    # a range whose scale is inexact: XLA rounds the fused multiply-add once
    for lo, hi in ((-0.3, 2.5), (1e-3, 7.0)):
        _assert_same_floats(prng.uniform(k, shape, "cpu", lo, hi),
                            jax.random.uniform(jk, shape, minval=lo, maxval=hi))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_normals_match_jax(seed, shape):
    """Bit for bit: the measured max difference is 0 ulp, so the
    tolerance is 0."""
    jk, k = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _assert_same_floats(prng.normal(k, shape, "cpu"), jax.random.normal(jk, shape))


def test_normals_of_derived_keys_match_jax():
    """The draws of gsjax's sites: split noise from a split key, a random
    background from a folded one."""
    key, jkey = prng.PRNGKey(0), jax.random.PRNGKey(0)
    for it in range(3):
        (key, k), (jkey, jk) = prng.split(key), jax.random.split(jkey)
        _assert_same_floats(prng.normal(k, (2, 257, 3), "cpu"),
                            jax.random.normal(jk, (2, 257, 3)))
        f, jf = prng.fold_in(k, it), jax.random.fold_in(jk, it)
        _assert_same_floats(prng.uniform(f, (3,), "cpu"), jax.random.uniform(jf, (3,)))


def _grid():
    """Every float32 region the polynomials branch on: uniforms over
    (-1, 1) and near the ends, the branch points, zero and the ends."""
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (300_000,), minval=-1, maxval=1))
    edge = 1 - np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (100_000,))) * 1e-3
    tiny = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (50_000,))) * 1e-4
    special = np.float32([0.0, -0.0, 1.0, -1.0, 0.99999994, -0.99999994, 0.41421356,
                          0.6435942, 0.9966, 0.99661, 1e-30, -1e-30])
    return np.concatenate([u, edge, -edge, tiny, -tiny, special]).astype(np.float32)


def test_erf_inv_matches_xla():
    x = _grid()
    _assert_same_floats(prng.erf_inv(torch.from_numpy(x)), lax.erf_inv(jnp.asarray(x)))
    # torch's own erfinv is not XLA's: the reason this module has its own
    off = (_bits_of(torch.erfinv(torch.from_numpy(x)).numpy())
           != _bits_of(lax.erf_inv(jnp.asarray(x)))).mean()
    assert off > 0.01


def test_log1p_and_log_match_xla():
    """The two pieces of erf_inv's ``-log1p(-x * x)``: XLA's CPU log1p
    (Cephes' rational approximation below sqrt(2) - 1, log(1 + x) beyond)
    and log (Cephes' logf), over their whole input ranges here."""
    x = _grid()
    m = -(x * x)
    _assert_same_floats(prng._log1p(torch.from_numpy(m)), jax.jit(lax.log1p)(jnp.asarray(m)))
    pos = np.concatenate([np.abs(x), np.abs(x) * 1e3, [np.inf, 1e-40, np.finfo(np.float32).tiny]])
    pos = pos.astype(np.float32)
    _assert_same_floats(prng._log(torch.from_numpy(pos)), jax.jit(jnp.log)(jnp.asarray(pos)))


def test_draws_take_the_device_they_are_given():
    k = prng.PRNGKey(1)
    for fn in (prng.bits, prng.uniform, prng.normal):
        assert fn(k, (4,), torch.device("cpu")).device.type == "cpu"
    # split and fold_in stay on the host
    assert isinstance(prng.split(k), np.ndarray) and isinstance(prng.fold_in(k, 2), np.ndarray)
