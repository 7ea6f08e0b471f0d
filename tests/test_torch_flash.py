"""The port's flash attention on the CPU (its plain version, ``flash_ref``)
against the reference's Pallas kernel in interpret mode and its oracle.

Inputs are made from a numpy seed and handed to both packages. Tolerances
are the reference's own (``tests/test_kernels.py``): 2e-5 in float32,
2e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(seed, BH, BHkv, S, dh, dtype):
    """q [BH, S, dh] and k, v [BHkv, S, dh]: numpy normals cast to dtype,
    as jax arrays and as torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((BH, S, dh), (BHkv, S, dh), (BHkv, S, dh))]
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def close(out, ref, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("BH,S,dh,bq,bk,dtype,causal", [
    (2, 256, 64, 64, 64, "float32", True),
    (2, 256, 64, 64, 128, "float32", False),
    (4, 512, 128, 128, 256, "bfloat16", True),
    (1, 128, 32, 128, 64, "float32", True),
    (3, 384, 64, 128, 128, "bfloat16", True),
])
def test_flash_matches_reference_kernel(BH, S, dh, bq, bk, dtype, causal):
    """The five shapes of the reference's own kernel test."""
    (q, k, v), (tq, tk, tv) = inputs(BH * S, BH, BH, S, dh, dtype)
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    close(out, jax_flash(q, k, v, causal=causal, block_q=bq, block_k=bk,
                         interpret=True), dtype)
    close(out, jax_flash_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_reads_kv_head_h_div_g(dtype):
    """G = 2 with distinct K/V per KV head: query row-set i reads KV row-set
    i // G, which is the reference called with K/V repeated per group
    (``jnp.repeat``), not tiled."""
    B, H, Hkv, S, dh = 2, 4, 2, 128, 32
    G = H // Hkv
    (q, k, v), (tq, tk, tv) = inputs(7, B * H, B * Hkv, S, dh, dtype)
    out = fa.flash_attention(tq, tk, tv)
    kr, vr = jnp.repeat(k, G, axis=0), jnp.repeat(v, G, axis=0)
    close(out, jax_flash(q, kr, vr, block_q=64, block_k=64, interpret=True),
          dtype)
    close(out, jax_flash_ref(q, kr, vr), dtype)
    tiled = jax_flash_ref(q, jnp.tile(k, (G, 1, 1)), jnp.tile(v, (G, 1, 1)))
    assert np.abs(out.float().numpy() - np.asarray(tiled, np.float32)).max() \
        > 10 * TOL[dtype]


@pytest.mark.parametrize("S,causal,dtype", [(200, True, "float32"),
                                            (1000, True, "bfloat16"),
                                            (77, False, "float32")])
def test_any_sequence_length(S, causal, dtype):
    """S that is no multiple of the kernel's 64-row tile."""
    (q, k, v), (tq, tk, tv) = inputs(S, 3, 3, S, 64, dtype)
    close(fa.flash_attention(tq, tk, tv, causal=causal),
          jax_flash_ref(q, k, v, causal=causal), dtype)


def test_plain_version_is_the_cpu_path_and_is_not_counted():
    _, (tq, tk, tv) = inputs(0, 4, 2, 64, 16, "float32")
    fa.reset_counts()
    out = fa.flash_attention(tq, tk, tv)
    assert torch.equal(out, flash_ref(tq, tk, tv))
    assert fa.COUNTS == {"flash_attention_sm90": 0,
                         "flash_attention_simt": 0,
                         "flash_attention_bwd": 0,
                         "flash_attention_bwd_sm90": 0}


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_attention_sm90",
                                     "flash_attention_simt"])
@pytest.mark.parametrize("dh", [64, 112, 128])
def test_every_wrapper_runs_the_plain_version_on_the_cpu(wrapper, dh):
    """bf16 at the tensor-core kernel's head dims: on CPU tensors each
    wrapper returns ``flash_ref``'s output and bumps neither counter."""
    _, (tq, tk, tv) = inputs(dh, 4, 2, 40, dh, "bfloat16")
    fa.reset_counts()
    out = getattr(fa, wrapper)(tq, tk, tv, causal=False)
    assert torch.equal(out, flash_ref(tq, tk, tv, causal=False))
    assert not any(fa.COUNTS.values())


@pytest.mark.parametrize("dtype,dh,kernel", [
    (torch.bfloat16, 128, "flash_attention_sm90"),
    (torch.bfloat16, 64, "flash_attention_sm90"),
    (torch.bfloat16, 32, "flash_attention_simt"),
    (torch.bfloat16, 16, "flash_attention_simt"),
    (torch.bfloat16, 96, "flash_attention_sm90"),
    (torch.bfloat16, 112, "flash_attention_sm90"),
    (torch.bfloat16, 80, "flash_attention_sm90"),
    (torch.bfloat16, 72, "flash_attention_sm90"),
    (torch.bfloat16, 100, "flash_attention_simt"),
    (torch.bfloat16, 56, "flash_attention_simt"),
    (torch.bfloat16, 1, "flash_attention_simt"),
    (torch.float32, 128, "flash_attention_simt"),
    (torch.float32, 64, "flash_attention_simt"),
    (torch.float32, 16, "flash_attention_simt"),
])
def test_route_by_dtype_and_head_dim(dtype, dh, kernel):
    """bf16 with dh 64, or a multiple of 8 from 72 to 128 (computed at a
    tile width of 128 on zero columns), on the wgmma kernel; float32 and
    every other bf16 head dim up to 128 on the 3xTF32 kernel."""
    assert fa.route(dtype, dh) == kernel


@pytest.mark.parametrize("dtype,dh,match", [
    (torch.bfloat16, 129, "dh <= 128, got dh=129"),
    (torch.float32, 256, "dh <= 128, got dh=256"),
    (torch.bfloat16, 0, "dh <= 128, got dh=0"),
    (torch.float16, 64, "float32 or bfloat16, got torch.float16"),
    (torch.float64, 128, "float32 or bfloat16, got torch.float64"),
])
def test_route_raises_for_what_no_kernel_takes(dtype, dh, match):
    with pytest.raises(ValueError, match=match):
        fa.route(dtype, dh)


def test_wrapper_rejects_what_it_cannot_run():
    _, (tq, tk, tv) = inputs(0, 4, 2, 64, 16, "float32")
    with pytest.raises(ValueError, match="BHkv dividing BH"):
        fa.flash_attention(tq, tk.repeat(3, 1, 1)[:3], tv.repeat(3, 1, 1)[:3])
    with pytest.raises(ValueError, match="dtypes differ"):
        fa.flash_attention(tq, tk.double(), tv)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(*(t.to("meta") for t in (tq, tk, tv)))


def test_wrapper_error_messages():
    """What the wrappers say, on the CPU as on the card, for a head dim
    above 128, a dtype no kernel takes, BHkv not dividing BH, and a
    tensor-core call outside its contract."""
    _, (tq, tk, tv) = inputs(1, 4, 2, 16, 160, "float32")
    with pytest.raises(ValueError, match="dh <= 128, got dh=160"):
        fa.flash_attention(tq, tk, tv)
    _, (tq, tk, tv) = inputs(2, 4, 2, 16, 64, "float32")
    with pytest.raises(ValueError, match="float32 or bfloat16, got "
                                         "torch.float16"):
        fa.flash_attention(tq.half(), tk.half(), tv.half())
    with pytest.raises(ValueError, match=r"BHkv dividing BH; got q \(4, 16, "
                                         r"64\), k \(3, 16, 64\)"):
        fa.flash_attention(tq, tk[:1].repeat(3, 1, 1), tv[:1].repeat(3, 1, 1))
    with pytest.raises(ValueError, match="flash_attention_sm90 takes "
                                         "bfloat16 with dh in"):
        fa.flash_attention_sm90(tq, tk, tv)
    with pytest.raises(ValueError, match="dh <= 128, got dh=160"):
        fa.flash_attention_simt(*inputs(1, 4, 2, 16, 160, "float32")[1])
