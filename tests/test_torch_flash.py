"""The port's flash attention (tensorlink_tpu_torch/ops/attention.py) against
the JAX package's Pallas ``flash_attention`` in interpret mode, float32,
rtol = atol = 2e-5 — the tolerance tests/test_ops.py holds the kernel to
against the einsum.

- ``flash_attention_ref`` on tests/test_ops.py's four GQA/MHA/MQA shapes
  and its three sliding windows (smaller than, equal to and larger than
  the block), plus T = 100 and T = 37 (no multiple of the CUDA kernel's
  tiles) against the JAX einsum with the same mask.
- The wrapper keeps the JAX contract: ``ValueError`` when T is no
  multiple of its blocks; CPU tensors take the plain version (counted),
  never a launch.
- The CUDA launch contract refuses what the kernel does not take (f32
  head_dim 16, mixed dtypes, unpacked heads, a non-positive window); bf16
  takes any head_dim that is a multiple of 16 (test_ops.py's MQA shape).
- On the card (``cuda`` marker, skipped without one): the kernel against
  the plain version at f32 2e-5 and bf16 1.6e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorlink_tpu.models.transformer import _mask_bias, attention
from tensorlink_tpu.ops.attention import flash_attention as j_flash
from tensorlink_tpu_torch.ops import attention as tatt

# One intra-op thread. After an interpret-mode Pallas call in the same
# process, torch's intra-op worker threads can compute exp off by up to
# 1e-4 (the main thread does not): flash_attention_ref's weights then miss
# 2e-5. Reproduced in 5 of 24 fresh processes with 2 threads, 0 of 24
# with 1.
torch.set_num_threads(1)
# tlint: disable=TL006(read-only constant table)
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, T, Hq, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, T, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))


def _port(q, k, v, **kw):
    return tatt.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw
    ).numpy()


@pytest.mark.parametrize(
    "B,T,Hq,Hkv,hd,bq,bk",
    [
        (2, 256, 8, 2, 64, 64, 64),  # GQA, multi-block
        (1, 128, 4, 4, 32, 128, 128),  # MHA, single block
        (2, 128, 8, 1, 16, 32, 64),  # MQA, asymmetric blocks
        (1, 64, 2, 2, 128, 16, 16),  # many tiny blocks
    ],
)
def test_flash_ref_matches_pallas_interpret(B, T, Hq, Hkv, hd, bq, bk):
    q, k, v = _qkv(0, B, T, Hq, Hkv, hd)
    scale = hd**-0.5
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   scale=scale, block_q=bq, block_k=bk, interpret=True)
    got = _port(q, k, v, scale=scale, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [8, 64, 200])
def test_flash_ref_sliding_window_matches_pallas_interpret(window):
    B, T, Hq, Hkv, hd = 1, 128, 4, 2, 32
    q, k, v = _qkv(3, B, T, Hq, Hkv, hd)
    scale = hd**-0.5
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   scale=scale, block_q=32, block_k=32, interpret=True,
                   window=window)
    got = _port(q, k, v, scale=scale, block_q=32, block_k=32, window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("T,window", [(100, None), (37, None), (37, 16)])
def test_flash_ref_ragged_T_matches_jax_einsum(T, window):
    """T below one 128-row block passes the JAX gate whatever its value;
    the plain version equals the einsum under the same causal (+window)
    mask."""
    B, Hq, Hkv, hd = 2, 8, 2, 32
    q, k, v = _qkv(5, B, T, Hq, Hkv, hd)
    scale = hd**-0.5
    pos = jnp.broadcast_to(jnp.arange(T)[None, :], (B, T))
    bias = _mask_bias(pos, T, jnp.ones((B, T), bool), window)
    want = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias,
                     scale)
    got = _port(q, k, v, scale=scale, window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_flash_rejects_indivisible_seq():
    q = torch.zeros((1, 100, 4, 32))
    k = v = torch.zeros((1, 100, 2, 32))
    with pytest.raises(ValueError, match="divide block sizes"):
        tatt.flash_attention(q, k, v, scale=1.0, block_q=64, block_k=64)


def test_flash_cpu_takes_the_plain_version_and_counts_it():
    tatt.reset_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 64, 4, 2, 32))
    out = tatt.flash_attention(q, k, v, scale=0.5)
    assert tatt.flash_attention_ref.calls == 1
    assert tatt.flash_attention.launches == 0
    assert torch.equal(out, tatt.flash_attention_ref(q, k, v, scale=0.5))
    tatt.reset_counts()
    assert tatt.flash_attention_ref.calls == 0


def test_flash_rows_with_no_visible_key_are_zeros():
    """The kernel's guards, kept in the plain version: under a window a
    row always sees itself, so all rows are finite; the JAX floor keeps a
    zero denominator from giving NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 64, 2, 2, 32))
    out = tatt.flash_attention_ref(q, k, v, scale=0.1, window=1)
    assert torch.isfinite(out).all()
    # window 1: each row attends only itself, so the output is its own v
    np.testing.assert_allclose(out.numpy(), v.numpy(), **TOL)


@pytest.mark.parametrize("bad,err,match", [
    ("hd16", ValueError, "multiple of 32"),
    ("dtype", TypeError, "k and v must be"),
    ("heads", ValueError, "do not divide"),
    ("window", ValueError, "window must be positive"),
    ("unpacked", ValueError, r"packed \[H, hd\]"),
    ("cpu", TypeError, "CUDA device"),
])
def test_flash_launch_contract_refuses(bad, err, match):
    hd = 16 if bad == "hd16" else 32
    q = torch.zeros((1, 8, 4, hd))
    k = torch.zeros((1, 8, 3 if bad == "heads" else 2, hd))
    v = k.clone()
    window = None
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "window":
        window = 0
    elif bad == "unpacked":
        k = torch.zeros((1, 8, hd, 2)).transpose(2, 3)
    with pytest.raises(err, match=match):
        tatt._check_flash(q, k, v, window)


@pytest.mark.parametrize("hd,dtype,err,match", [
    (16, torch.bfloat16, TypeError, "CUDA device"),  # every shape check passes
    (48, torch.bfloat16, TypeError, "CUDA device"),
    (24, torch.bfloat16, ValueError, "multiple of 16"),
    (8, torch.bfloat16, ValueError, "multiple of 16"),
    (48, torch.float32, ValueError, "multiple of 32"),
])
def test_flash_launch_contract_head_dim_by_dtype(hd, dtype, err, match):
    """bf16 launches take the tensor-core kernel (head_dim a multiple of
    16, test_ops.py's MQA shape included); f32 keeps the scalar kernel's
    multiple of 32. A well-formed CPU launch stops at the device check."""
    q = torch.zeros((2, 8, 8, hd), dtype=dtype)
    k = torch.zeros((2, 8, 1, hd), dtype=dtype)
    with pytest.raises(err, match=match):
        tatt._check_flash(q, k, k.clone(), None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_matches_plain_version(dtype):
    """On the card: the kernel against the plain version, k/v read in
    place from a longer cache (f32 2e-5; bf16 compared in f32 at 1.6e-2,
    the output rounding once after another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    tol = TOL if dt == torch.float32 else dict(rtol=1.6e-2, atol=1.6e-2)
    for B, T, Hq, Hkv, hd, window in ((2, 256, 8, 2, 64, None),
                                      (2, 100, 16, 8, 128, None),
                                      (1, 128, 4, 2, 32, 8)):
        q, k, v = _qkv(4, B, T + 16, Hq, Hkv, hd)
        tq = torch.from_numpy(q[:, :T].copy()).to("cuda", dt)
        tk, tv = (torch.from_numpy(a).to("cuda", dt)[:, :T] for a in (k, v))
        got = tatt.flash_attention(tq, tk, tv, scale=hd**-0.5, window=window)
        want = tatt.flash_attention_ref(tq, tk, tv, scale=hd**-0.5,
                                        window=window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                                   **tol)
