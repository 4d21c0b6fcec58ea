"""The port's PRNG (`repro_torch/core/prng.py`) against `jax.random` with
its default threefry implementation: the keys, splits, fold-ins, raw bits
and uniforms bit for bit, over seeds {0, 1, 7, 12345, 2^31 - 1} and up to
49,152 draws (the starcoder2_3b vocabulary, one sampling step's Gumbel
row); the Gumbel draws within 1e-6 absolute, because torch's `log` and
XLA's differ in the last bits (up to 4.8e-7 on these draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng                             # noqa: E402

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1]
N = 49152
GUMBEL_ATOL = 1e-6


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _key(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS + [-1])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _u32(_key(seed)))


def test_split_of_seven_is_the_known_pair():
    np.testing.assert_array_equal(
        prng.split(prng.PRNGKey(7)).numpy(),
        [[3625411723, 1954958720], [195045567, 4062205631]])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 8, N])
def test_split(seed, n):
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), n).numpy(),
                                  _u32(jax.random.split(_key(seed), n)))


def test_split_of_a_batch_of_keys_is_each_keys_split():
    keys = np.stack([_u32(_key(s)) for s in SEEDS])
    got = prng.split(torch.from_numpy(keys)).numpy()
    want = np.stack([_u32(jax.random.split(_key(s))) for s in SEEDS])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 5, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in(seed, data):
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(seed), data).numpy(),
        _u32(jax.random.fold_in(_key(seed), data)))


def test_fold_in_by_tensor_per_row():
    keys = torch.from_numpy(np.stack([_u32(_key(s)) for s in SEEDS]))
    data = torch.arange(len(SEEDS)) * 1000
    got = prng.fold_in(keys, data).numpy()
    want = np.stack([_u32(jax.random.fold_in(_key(s), int(d)))
                     for s, d in zip(SEEDS, data)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, N])
def test_bits(seed, n):
    np.testing.assert_array_equal(
        prng.bits(prng.PRNGKey(seed), n).numpy(),
        _u32(jax.random.bits(_key(seed), (n,), jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0),
                                   (float(np.finfo(np.float32).tiny), 1.0),
                                   (-3.0, 0.5)])
def test_uniform_bitwise(seed, lo, hi):
    got = prng.uniform(prng.PRNGKey(seed), N, lo, hi).numpy()
    want = np.asarray(jax.random.uniform(_key(seed), (N,), jnp.float32,
                                         minval=lo, maxval=hi))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel(seed):
    got = prng.gumbel(prng.PRNGKey(seed), N).numpy()
    want = np.asarray(jax.random.gumbel(_key(seed), (N,), jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def test_gumbel_of_a_batch_of_keys_is_each_keys_vmapped_draw():
    """The sampler's form: one row of draws per slot key."""
    keys = np.stack([_u32(_key(s)) for s in SEEDS])
    got = prng.gumbel(torch.from_numpy(keys), 512).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (512,), jnp.float32))(jnp.asarray(keys, jnp.uint32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def test_seed_outside_32_bits_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31)
