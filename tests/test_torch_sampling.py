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
from llama_cu_awq_tpu.sampling import XorshiftRNG as JRNG
from llama_cu_awq_tpu.sampling import greedy as j_greedy
from llama_cu_awq_tpu.sampling import sample_token as j_sample


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
