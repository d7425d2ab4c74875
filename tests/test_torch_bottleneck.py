"""Port parity: the fused identity bottleneck
(``glsdet_tpu_torch/ops/bottleneck_kernel.py``; the CUDA kernel
``csrc/bottleneck.cu`` is held against the plain version on the card, in
tests/test_torch_cuda.py and chip_smoke.py), on the CPU.

- ``fused_bottleneck_plain`` and the wrapper on a CPU tensor against the
  Pallas kernel ``pallas_bottleneck.fused_bottleneck`` in interpret mode,
  at the JAX package's four test shapes and (2, 16, 16, 256), for float32
  and bfloat16 inputs: max |error| <= 5e-3 * max|jax| (the two differ in
  the order of the float32 sums, so a bf16 intermediate can round to its
  other neighbour), and the output dtype is ``x.dtype``.
- The port's conv+BN fold against the JAX ``_fold`` to 1e-6, conv1 to
  conv3, and the (9C, C) tap order of the folded 3x3.
- The wrapper serves CPU tensors only and never builds without ``nvcc``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glsdet_tpu.models.resnet import Bottleneck as JBottleneck
from glsdet_tpu.ops.fused_infer import _fold as jax_fold
from glsdet_tpu.ops.pallas_bottleneck import \
    fused_bottleneck as pallas_fused_bottleneck
from glsdet_tpu_torch.models.resnet import Bottleneck
from glsdet_tpu_torch.native import kernels
from glsdet_tpu_torch.ops import bottleneck_kernel as bk
from glsdet_tpu_torch.ops.fused_infer import FusedBottleneck, _fold
from torch_port_util import flax_vars, load_flax

SHAPES = [(2, 16, 24, 32), (1, 8, 8, 64), (2, 10, 16, 32), (1, 16, 40, 128),
          (2, 16, 16, 256)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _block(shape):
    """x and folded weights (w2 as the JAX kernel takes it, (3, 3, C, C))
    as float32 numpy."""
    rs = np.random.RandomState(sum(shape))
    cin = shape[-1]
    c = cin // 4
    x = rs.randn(*shape).astype(np.float32)
    ws = [rs.randn(cin, c) * 0.1, rs.randn(c) * 0.1,
          rs.randn(3, 3, c, c) * 0.1, rs.randn(c) * 0.1,
          rs.randn(c, cin) * 0.1, rs.randn(cin) * 0.1]
    return x, [w.astype(np.float32) for w in ws]


@functools.lru_cache(maxsize=None)
def _jax_out(shape, dtype):
    x, ws = _block(shape)
    got = pallas_fused_bottleneck(
        jnp.asarray(x).astype(DTYPES[dtype][1]),
        *[jnp.asarray(w) for w in ws], interpret=True)
    assert got.dtype == DTYPES[dtype][1]
    return np.asarray(got.astype(jnp.float32))


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel(shape, dtype, fn):
    x, ws = _block(shape)
    c = shape[-1] // 4
    tx = torch.from_numpy(x.copy()).to(DTYPES[dtype][0])
    tw = [torch.from_numpy(w.copy()) for w in ws]
    tw[2] = tw[2].reshape(9 * c, c)      # the port's layout, JAX tap order
    f = bk.fused_bottleneck_plain if fn == "plain" else bk.fused_bottleneck
    got = f(tx, *tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want = _jax_out(shape, dtype)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 5e-3 * np.abs(want).max(), (err, np.abs(want).max())


def test_residual_and_zero_halo():
    """Zero weights leave relu(x + b3): conv1's bias must not leak into
    the 3x3's padding (with w2 = 0 it cannot), and with w1 = 0 the halo
    rule shows at the border: y1 = relu(b1) inside, 0 outside."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(1, 4, 5, 64).astype(np.float32))
    z = torch.zeros
    b3 = torch.from_numpy(rs.randn(64).astype(np.float32))
    got = bk.fused_bottleneck_plain(x, z(64, 16), z(16), z(9 * 16, 16),
                                    z(16), z(16, 64), b3)
    xb = x.to(torch.bfloat16).float()
    torch.testing.assert_close(got, torch.relu(xb + b3), rtol=0, atol=0)
    # w1 = 0, b1 = 1: y1 = 1 inside; w2 sums the taps; w3 = identity on
    # the first 16 channels; so y2 counts the in-image neighbours
    w3 = torch.zeros(16, 64)
    w3[:, :16] = torch.eye(16)
    got = bk.fused_bottleneck_plain(z(1, 4, 5, 64), z(64, 16),
                                    torch.ones(16), torch.ones(144, 16) / 16,
                                    z(16), w3, z(64))
    counts = torch.tensor([[4., 6, 6, 6, 4], [6, 9, 9, 9, 6],
                           [6, 9, 9, 9, 6], [4, 6, 6, 6, 4]])
    torch.testing.assert_close(got[0, :, :, 0], counts, rtol=0, atol=0)


@pytest.fixture(scope="module")
def block_pair():
    """A JAX identity Bottleneck (C = 16) with perturbed BN statistics and
    its port, loaded from the same flax variables."""
    jb = JBottleneck(channels=16)
    variables = flax_vars(jb, np.zeros((1, 8, 8, 64), np.float32))
    return variables, load_flax(Bottleneck(64, 16), variables)


@pytest.mark.parametrize("name", ["conv1", "conv2", "conv3"])
def test_fold_matches_jax(block_pair, name):
    variables, block = block_pair
    want_k, want_b = jax_fold(variables["params"], variables["batch_stats"],
                              name)
    got_k, got_b = _fold(getattr(block, name))
    assert tuple(got_k.shape) == want_k.shape
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6,
                               atol=1e-6)


def test_folded_operands_in_kernel_layout(block_pair):
    """``FusedBottleneck`` holds what ``pallas_bottleneck.fused_bottleneck``
    hands its kernel: bf16 w1 (4C, C), w2 (9C, C) in tap order (dh major,
    dw minor), w3 (C, 4C), and float32 biases."""
    variables, block = block_pair
    fused = FusedBottleneck(block)
    p, s = variables["params"], variables["batch_stats"]
    for i, rows in ((1, 64), (2, 144), (3, 16)):
        k, b = jax_fold(p, s, f"conv{i}")
        want = np.asarray(k.reshape(rows, -1).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        got = getattr(fused, f"w{i}")
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
        bias = getattr(fused, f"b{i}")
        assert bias.dtype == torch.float32
        np.testing.assert_allclose(bias.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_wrapper_takes_no_other_device():
    """The plain version serves CPU tensors only; other devices raise
    instead of falling back."""
    meta = torch.empty(1, 8, 8, 64, device="meta")
    w = [torch.empty(s, device="meta") for s in
         ((64, 16), (16,), (144, 16), (16,), (16, 64), (64,))]
    with pytest.raises(ValueError, match="no bottleneck kernel for device"):
        bk.fused_bottleneck(meta, *w)


def test_kernels_do_not_build_without_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the kernels library raises instead of
    loading anything else."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load_kernels()
