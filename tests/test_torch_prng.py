"""The port's counter-based PRNG (``minigrid_tpu_torch/ops/prng.py``)
against the Random123 known-answer vectors and the JAX package's
``minigrid_tpu/ops/prng.py``: the same words for the same keys and
counters, and the same indices wherever the JAX package's int32
``uniform_index`` does not wrap (count <= 128)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigrid_tpu.ops import prng as jprng
from minigrid_tpu_torch.ops import prng as tprng

# Random123's threefry2x32_20 vectors (tests/test_pallas_ops.py:45-75).
KNOWN_ANSWERS = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


def _as_int32(v: int) -> int:
    return v - 2**32 if v >= 2**31 else v


@pytest.mark.parametrize("case", range(len(KNOWN_ANSWERS)))
def test_threefry2x32_known_answer_vectors(case):
    (k0, k1), (x0, x1), want = KNOWN_ANSWERS[case]
    y0, y1 = tprng.threefry2x32(k0, k1, x0, x1)
    assert (int(y0), int(y1)) == want
    # int32 words are taken by their bits, as the kernel's seeds are.
    args = [torch.tensor([_as_int32(v)], dtype=torch.int32) for v in (k0, k1, x0, x1)]
    y0, y1 = tprng.threefry2x32(*args)
    assert (int(y0), int(y1)) == want
    assert tprng.to_int32(y0).dtype == torch.int32 and int(tprng.to_int32(y0)) == _as_int32(want[0])


def test_threefry2x32_equals_jax_on_random_words():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (4, 4096), dtype=np.uint64).astype(np.uint32)
    j0, j1 = jprng.threefry2x32(*(jnp.asarray(w) for w in words))
    t0, t1 = tprng.threefry2x32(*(torch.from_numpy(w.view(np.int32)) for w in words))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("count", [1, 2, 4, 9, 37, 128])
def test_uniform_index_equals_jax_up_to_128(count):
    rng = np.random.default_rng(count)
    bits = np.concatenate(
        [rng.integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32), np.array([0, 255, 0xFFFFFFFF], np.uint32)]
    )
    want = np.asarray(jprng.uniform_index(jnp.asarray(bits), jnp.int32(count)))
    got = tprng.uniform_index(torch.from_numpy(bits.astype(np.int64)), count)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < count


def test_uniform_index_does_not_wrap_past_128():
    # The JAX package's int32 product wraps: this word gives -62 of 195 there
    # (minigrid_tpu/ops/prng.py:67-68); the port gives the top index.
    assert int(jprng.uniform_index(jnp.uint32(0xFFFFFF00), jnp.int32(195))) == -62
    assert int(tprng.uniform_index(torch.tensor(0xFFFFFF00), 195)) == 194
    bits, _ = tprng.threefry2x32(7, 11, torch.arange(1 << 16), 0)
    for count in (195, 1000, 1 << 20):
        idx = tprng.uniform_index(bits, count)
        assert idx.min() >= 0 and idx.max() < count
    # Uniform over 195 bins: every bin within 6 sigma of its expectation.
    counts = torch.bincount(tprng.uniform_index(bits, 195), minlength=195).double()
    expect = (1 << 16) / 195
    assert float((counts - expect).abs().max()) < 6 * expect**0.5
