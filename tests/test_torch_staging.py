"""Port staging (phfpfac_tpu_torch.ops.staging) vs the JAX staging jits.

Exact equality (tolerance 0): both produce int32 device formats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.ops.pallas_depth import stage_input as jax_stage_input
from phfpfac_tpu.ops.pallas_depth import staged_rows as jax_staged_rows
from phfpfac_tpu.ops.pallas_pair import stage_pairs as jax_stage_pairs
from phfpfac_tpu_torch.ops.common import pad_input
from phfpfac_tpu_torch.ops.staging import (
    stage_input,
    stage_pairs,
    staged_rows,
    to_device_bytes,
)

# (corpus length, input_size shortfall, max_steps)
CASES = [(1, 0, 8), (1000, 1, 8), (3000, 0, 16), (5000, 700, 32)]


def _padded(seed, n, max_steps):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    return pad_input(data, 1024, max_steps)


@pytest.mark.parametrize("seed,case", list(enumerate(CASES)))
def test_stage_input_matches_jax(seed, case):
    n, short, max_steps = case
    padded = _padded(seed, n, max_steps)
    input_size = n - short
    n_rows = staged_rows(len(padded) - max_steps)
    assert n_rows == jax_staged_rows(len(padded) - max_steps)
    want = np.asarray(jax_stage_input(
        jnp.asarray(padded), jnp.asarray(np.int32(input_size)),
        n_rows=n_rows,
    ))
    got = stage_input(to_device_bytes(padded, "cpu"), input_size,
                      n_rows=n_rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.reshape(-1)[input_size:] == 256).all()  # PAD_CHAR


@pytest.mark.parametrize("cb,sigma", [(4, 12), (7, 100), (9, 256)])
@pytest.mark.parametrize("seed,case", list(enumerate(CASES)))
def test_stage_pairs_matches_jax(seed, case, cb, sigma):
    n, short, max_steps = case
    padded = _padded(seed, n, max_steps)
    input_size = n - short
    rng = np.random.default_rng(seed + 99)
    code_of = np.full(256, sigma, np.int32)  # unused bytes -> miss code
    used = rng.choice(256, size=min(sigma, 256), replace=False)
    code_of[np.sort(used)] = np.arange(len(used), dtype=np.int32)
    n_rows = staged_rows(len(padded) - max_steps)
    want = np.asarray(jax_stage_pairs(
        jnp.asarray(padded), jnp.asarray(np.int32(input_size)),
        jnp.asarray(code_of), n_rows=n_rows, cb=cb,
    ))
    got = stage_pairs(to_device_bytes(padded, "cpu"), input_size,
                      torch.from_numpy(code_of), n_rows=n_rows, cb=cb)
    np.testing.assert_array_equal(got.numpy(), want)
    # past input_size every pair is (miss << cb) | miss
    miss = int(code_of.max())
    tail = got.reshape(-1)[input_size:]
    assert (tail == ((miss << cb) | miss)).all()
