"""The PyTorch port's fused embed + dense-1 op against the JAX package's
Pallas kernel (interpret mode), forward and gradients.

On the CPU the port runs ``embed_dense1_reference`` (the one-hot features
made explicit, autograd for the gradients).  Both packages get the same
flax parameters and packed observations: Empty-5x5 resets and random
object-rich 9x7 states.  Forward outputs agree to atol 2e-2 (bf16
activations); gradients to atol 2e-2 x max(1, |g|max), as in
tests/test_embed_dense.py.  The CUDA kernels themselves are held against
the plain version on a GPU by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigrid_tpu.ops.embed_dense import embed_dense1 as j_embed_dense1
from minigrid_tpu.rl.model import apply_packed_fused as j_apply_packed_fused
from minigrid_tpu_torch.ops import embed_dense as ed
from minigrid_tpu_torch.rl.model import apply_packed_fused
from minigrid_tpu_torch.utils.bridge import params_to_flax
from torch_port_util import flax_params, observations, port_model

N_EACH = 128  # 256 samples in all


@pytest.fixture(scope="module")
def case():
    packed, direction = observations(N_EACH, seed=3)
    _, params = flax_params(packed, direction, seed=5)
    return packed, direction, params


def test_embed_dense1_forward_matches_jax_kernel(case):
    packed, direction, params = case
    p = params["params"]["Dense_0"]
    want = j_embed_dense1(
        jnp.asarray(p["kernel"]), jnp.asarray(p["bias"]), jnp.asarray(packed), jnp.asarray(direction), 7,
        interpret=True,
    )
    before = dict(ed.KERNEL_LAUNCHES)
    got = ed.embed_dense1(
        torch.from_numpy(p["kernel"]), torch.from_numpy(p["bias"]),
        torch.from_numpy(packed), torch.from_numpy(direction),
    )
    assert ed.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (2 * N_EACH, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=2e-2)


@pytest.mark.parametrize("lead", [(256,), (4, 64)])
def test_apply_packed_fused_matches_jax(case, lead):
    packed, direction, params = case
    pk, dr = packed.reshape(lead + (49,)), direction.reshape(lead)
    want_logits, want_value = j_apply_packed_fused(params, jnp.asarray(pk), jnp.asarray(dr), interpret=True)
    model = port_model(params)
    with torch.no_grad():
        logits, value = apply_packed_fused(model, torch.from_numpy(pk), torch.from_numpy(dr))
    assert logits.shape == lead + (7,) and value.shape == lead
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=2e-2)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=0, atol=2e-2)


def test_gradients_match_jax_custom_vjp(case):
    packed, direction, params = case

    def loss_jax(p):
        logits, value = j_apply_packed_fused(p, jnp.asarray(packed), jnp.asarray(direction), interpret=True)
        return jax.nn.log_softmax(logits).sum() * 1e-3 + value.sum() * 1e-3

    want = jax.grad(loss_jax)(jax.tree.map(jnp.asarray, params))
    model = port_model(params)
    logits, value = apply_packed_fused(model, torch.from_numpy(packed), torch.from_numpy(direction))
    loss = torch.log_softmax(logits, dim=-1).sum() * 1e-3 + value.sum() * 1e-3
    loss.backward()
    got = params_to_flax({k: p.grad for k, p in model.named_parameters()})
    want_leaves, want_tree = jax.tree.flatten(want)
    got_leaves, got_tree = jax.tree.flatten(got)
    assert want_tree == got_tree
    for a, b in zip(got_leaves, want_leaves):
        b = np.asarray(b, np.float32)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * scale)


def test_reference_fields_out_of_range_select_no_row():
    # A type >= 11 or color >= 6 selects no row; the state is clipped to
    # [0, 2]; a direction outside [0, 4) selects no row.
    w1 = torch.arange(20 + 4, dtype=torch.float32)[:, None].repeat(1, 4)
    b1 = torch.zeros(4)
    packed = torch.tensor([[12 | (7 << 8) | (5 << 16)], [3 | (2 << 8) | (1 << 16)]], dtype=torch.int32)
    direction = torch.tensor([4, 1], dtype=torch.int32)
    out = ed.embed_dense1_reference(w1, b1, packed, direction)
    assert out[0].tolist() == [19.0] * 4  # the clipped state row only
    assert out[1].tolist() == [3.0 + 13.0 + 18.0 + 21.0] * 4


@pytest.mark.parametrize("m", [1, 4097, ed.BWD_CHUNK, ed.BWD_CHUNK + 1, 131072 + 17])
@pytest.mark.parametrize("hidden", [32, 256])
def test_backward_scratch_covers_ragged_m(m, hidden):
    chunks, rows, width = ed.backward_scratch_shape(m, 49, hidden)
    assert (chunks - 1) * ed.BWD_CHUNK < m <= chunks * ed.BWD_CHUNK
    assert rows == 49 * 20 + 5  # dW1's rows and db1's
    assert width == max(hidden, 64) and width % 64 == 0


@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_padded_backward_width_gives_the_plain_and_jax_gradient(case, hidden):
    # The backward kernel runs at least 64 columns wide: a narrower dy is
    # padded with zero columns and their gradients dropped.  The padded
    # problem's plain gradient, sliced, is the unpadded one and JAX's.
    packed, direction, _ = case
    rng = np.random.default_rng(hidden)
    m = packed.shape[0]
    w1 = torch.from_numpy(rng.normal(0, 0.03, (49 * 20 + 4, hidden)).astype(np.float32))
    b1 = torch.from_numpy(rng.normal(0, 0.1, hidden).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1e-2, (m, hidden)).astype(np.float32)).to(torch.bfloat16)
    pk, dr = torch.from_numpy(packed), torch.from_numpy(direction)
    pad = ed.backward_width(hidden) - hidden

    def grads(w, b, g):
        w, b = w.clone().requires_grad_(), b.clone().requires_grad_()
        return torch.autograd.grad(ed.embed_dense1_reference(w, b, pk, dr), (w, b), g)

    f = torch.nn.functional.pad
    dw_p, db_p = grads(f(w1, (0, pad)), f(b1, (0, pad)), f(dy, (0, pad)))
    dw, db = grads(w1, b1, dy)
    _, vjp = jax.vjp(
        lambda w, b: j_embed_dense1(w, b, jnp.asarray(packed), jnp.asarray(direction), 7, interpret=True),
        jnp.asarray(w1.numpy()), jnp.asarray(b1.numpy()),
    )
    j_dw, j_db = vjp(jnp.asarray(dy.float().numpy()).astype(jnp.bfloat16))
    for got_p, got, want in ((dw_p, dw, j_dw), (db_p, db, j_db)):
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        assert not got_p[..., hidden:].any()
        torch.testing.assert_close(got_p[..., :hidden].float(), got.float(), rtol=0, atol=2e-2 * scale)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2 * scale)
