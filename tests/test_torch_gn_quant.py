"""Port parity: GroupNorm -> ReLU -> int8 requant
(``glsdet_tpu_torch/ops/gn_kernel.py: gn_relu_quant_plain``, the plain
version of the CUDA kernel ``csrc/gn_quant.cu``), on the CPU.

- float32 input: against ``quant_static._gn_relu`` at float32 followed by
  the requant (the int8 head's path on the CPU): codes within +-1 and
  >= 99.9% equal, the slack being the order of the float32 statistics
  sums and XLA's handling of the division by the constant scale.
- bfloat16 input: against the Pallas kernel ``pallas_gn.gn_relu_quant``
  in interpret mode (the kernel the CUDA kernel replaces), at small
  shapes because interpret mode is slow: codes within +-1.
- constant input (zero variance, no association ambiguity): equal.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.ops.pallas_gn import gn_relu_quant as pallas_gn_relu_quant
from glsdet_tpu.ops.quant_static import _gn_relu
from glsdet_tpu_torch.ops import gn_kernel


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    y = (rs.randn(*shape) * rs.uniform(0.5, 4)
         + rs.randn(c) * 0.5).astype(np.float32)      # per-channel offset
    gamma = rs.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rs.randn(c) * 0.3).astype(np.float32)
    return y, gamma, beta, float(rs.uniform(0.01, 0.2))


def _jax_f32_codes(y, gamma, beta, s_out, groups=32):
    v = _gn_relu(jnp.asarray(y), {"scale": jnp.asarray(gamma),
                                  "bias": jnp.asarray(beta)},
                 groups, jnp.float32)
    return np.asarray(jnp.clip(jnp.round(v / s_out), -127, 127)
                      .astype(jnp.int8))


def _plain(y, gamma, beta, s_out, dtype=torch.float32):
    return gn_kernel.gn_relu_quant_plain(
        torch.from_numpy(y.copy()).to(dtype), torch.from_numpy(gamma),
        torch.from_numpy(beta), s_out, groups=32, eps=1e-6).numpy()


@pytest.mark.parametrize("shape", [(2, 16, 16, 256), (1, 9, 9, 128),
                                   (3, 8, 24, 64), (2, 36, 36, 256)])
def test_float32_matches_gn_relu(shape):
    y, gamma, beta, s_out = _inputs(shape, sum(shape))
    want = _jax_f32_codes(y, gamma, beta, s_out)
    got = _plain(y, gamma, beta, s_out)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999
    assert (got != 0).mean() > 0.3                    # not all clipped


@pytest.mark.parametrize("shape", [(1, 16, 16, 128), (2, 8, 24, 128)])
def test_bfloat16_matches_the_pallas_kernel(shape):
    y, gamma, beta, s_out = _inputs(shape, 7 + sum(shape))
    y_bf = np.asarray(jnp.asarray(y, jnp.bfloat16), np.float32)
    want = np.asarray(pallas_gn_relu_quant(
        jnp.asarray(y_bf, jnp.bfloat16), jnp.asarray(gamma),
        jnp.asarray(beta), s_out, groups=32, interpret=True))
    got = _plain(y_bf, gamma, beta, s_out, torch.bfloat16)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99


def test_constant_input_exact():
    y = np.full((1, 8, 8, 128), 2.5, np.float32)
    gamma, beta = np.ones(128, np.float32), np.zeros(128, np.float32)
    want = np.asarray(pallas_gn_relu_quant(
        jnp.asarray(y, jnp.bfloat16), jnp.asarray(gamma), jnp.asarray(beta),
        0.05, interpret=True))
    np.testing.assert_array_equal(
        _plain(y, gamma, beta, 0.05, torch.bfloat16), want)
    np.testing.assert_array_equal(_plain(y, gamma, beta, 0.05),
                                  _jax_f32_codes(y, gamma, beta, 0.05))


def test_wrapper_takes_the_plain_version_on_a_cpu_tensor():
    y, gamma, beta, s_out = _inputs((2, 9, 9, 64), 3)
    before = gn_kernel.launches
    for dtype in (torch.float32, torch.bfloat16):
        got = gn_kernel.gn_relu_quant(
            torch.from_numpy(y.copy()).to(dtype), torch.from_numpy(gamma),
            torch.from_numpy(beta), s_out)
        np.testing.assert_array_equal(got.numpy(),
                                      _plain(y, gamma, beta, s_out, dtype))
    assert gn_kernel.launches == before       # no kernel on the CPU
