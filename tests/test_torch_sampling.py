"""The port's sampler against the JAX package's, on the CPU.

The xorshift coins must be bit-identical (both are the same integer
arithmetic on Python ints). sample_token must pick the same token from
the same f32 logits and coins: the two softmaxes may differ in the last
f32 bit, which moves a pick only when a coin falls within ~1e-7 of a CDF
step; the seeded inputs below are fixed, so the check is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.sampling import XorshiftRNG as TRNG
from llama_cu_awq_torch.sampling import greedy as t_greedy
from llama_cu_awq_torch.sampling import sample_token as t_sample
from llama_cu_awq_torch.sampling import sample_token_vec as t_sample_vec
from llama_cu_awq_tpu.sampling import XorshiftRNG as JRNG
from llama_cu_awq_tpu.sampling import greedy as j_greedy
from llama_cu_awq_tpu.sampling import sample_token as j_sample
from llama_cu_awq_tpu.sampling import sample_token_vec as j_sample_vec

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [1, 1234, 2 ** 63 + 12345, 2 ** 64 + 7])
def test_xorshift_coins_bit_identical(seed):
    t, j = TRNG(seed), JRNG(seed)
    for _ in range(2000):
        assert t.random_u32() == j.random_u32()
        assert t.random_f32() == j.random_f32()
    assert t.state == j.state


def _logits_and_coins(seed, rows=64, vocab=512):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    gen = TRNG(seed)
    coins = np.array([gen.random_f32() for _ in range(rows)], np.float32)
    return logits, coins


@pytest.mark.parametrize("temperature,topp", [
    (0.0, 0.6),   # greedy
    (0.8, 1.0),   # CDF inversion over the unsorted softmax
    (0.8, 0.0),   # topp outside (0, 1): the same plain CDF
    (0.5, 0.6),   # top-p over the stable descending sort
    (1.3, 0.9),
])
def test_sample_token_picks_identical_tokens(temperature, topp):
    logits, coins = _logits_and_coins(11)
    got = t_sample(torch.from_numpy(logits), torch.from_numpy(coins),
                   temperature, topp)
    want = j_sample(jnp.asarray(logits), jnp.asarray(coins), temperature,
                    topp)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_greedy_ties_pick_the_first_index():
    logits = np.zeros((2, 16), np.float32)
    logits[0, [3, 9]] = 1.0
    logits[1, [0, 15]] = 2.0
    got = t_greedy(torch.from_numpy(logits)).numpy()
    assert np.array_equal(got, np.asarray(j_greedy(jnp.asarray(logits))))
    assert got.tolist() == [3, 0]


@pytest.mark.parametrize("seed", [3, 11])
def test_sample_token_vec_per_row_parameters(seed):
    """Per-row temperature and top-p (the batch engine's sampler): greedy,
    plain-CDF and nucleus rows in one call pick the JAX function's tokens,
    and each row the token sample_token picks with its own parameters."""
    logits, coins = _logits_and_coins(seed)
    rows = logits.shape[0]
    temps = np.array([(0.0, 0.8, 0.5, 1.3)[i % 4] for i in range(rows)],
                     np.float32)
    topps = np.array([(0.6, 1.0, 0.6, 0.0)[i % 4] for i in range(rows)],
                     np.float32)
    got = t_sample_vec(*(torch.from_numpy(a)
                         for a in (logits, coins, temps, topps)))
    want = j_sample_vec(*(jnp.asarray(a)
                          for a in (logits, coins, temps, topps)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    for i in range(4):
        one = t_sample(torch.from_numpy(logits[i::4]),
                       torch.from_numpy(coins[i::4]), float(temps[i]),
                       float(topps[i]))
        assert np.array_equal(got.numpy()[i::4], one.numpy())
