"""The gradient of the port's flash attention on the CPU: the backward
kernel's plain version ``flash_bwd_ref`` and the autograd wrapper
``FlashAttention`` against ``torch.autograd`` of ``flash_ref`` and against
``jax.vjp`` of the reference's oracle ``repro.kernels.ref.flash_ref``.

Inputs and the incoming gradient are numpy normals from a seed, handed to
both packages. The reference's oracle has no grouped-query form, so it gets
K/V repeated per group (``jnp.repeat``), whose vjp sums the G gradients of
each key/value row-set, as the kernel does. Tolerance: float32, 1e-4 of
each output's max (sums in another order; measured about 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_bwd_ref, flash_ref

REL = 1e-4
# (BHkv, G, S, dh): S off the kernel's 64-row tile (77, 130) and on it
SHAPES = [(2, 1, 64, 32), (2, 2, 77, 16), (1, 4, 130, 64), (3, 2, 128, 8)]


def inputs(seed, BHkv, G, S, dh):
    rng = np.random.default_rng(seed)
    shapes = ((BHkv * G, S, dh), (BHkv, S, dh), (BHkv, S, dh),
              (BHkv * G, S, dh))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def close(out, ref):
    out = out.detach().numpy() if torch.is_tensor(out) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= REL * np.abs(ref).max()


def autograd_of_flash_ref(q, k, v, do, causal):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    flash_ref(q, k, v, causal).backward(torch.from_numpy(do))
    return q.grad, k.grad, v.grad


def vjp_of_reference(q, k, v, do, causal):
    G = q.shape[0] // k.shape[0]

    def f(q, k, v):
        return jax_flash_ref(q, jnp.repeat(k, G, axis=0),
                             jnp.repeat(v, G, axis=0), causal=causal)

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return o, vjp(jnp.asarray(do))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S,dh", SHAPES)
def test_flash_bwd_ref_matches_autograd_and_reference(BHkv, G, S, dh,
                                                      causal):
    q, k, v, do = inputs(S * 10 + G, BHkv, G, S, dh)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = flash_ref(tq, tk, tv, causal)
    grads = flash_bwd_ref(tq, tk, tv, o, tdo, causal)
    assert [g.shape for g in grads] == [tq.shape, tk.shape, tv.shape]
    for got, want in zip(grads, autograd_of_flash_ref(q, k, v, do, causal)):
        close(got, want)
    ref_o, ref_grads = vjp_of_reference(q, k, v, do, causal)
    close(o, ref_o)
    for got, want in zip(grads, ref_grads):
        close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S,dh", SHAPES)
def test_flash_attention_function_gives_the_same_gradients(BHkv, G, S, dh,
                                                           causal):
    """Under grad ``flash_attention`` runs ``FlashAttention``: its
    backward (``flash_attention_bwd``, the plain version on the CPU)
    gives autograd's gradients of ``flash_ref`` and the reference's; with
    no input requiring grad it returns a plain tensor."""
    q, k, v, do = inputs(S * 10 + G + 1, BHkv, G, S, dh)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    fa.reset_counts()
    out = fa.flash_attention(tq, tk, tv, causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert not any(fa.COUNTS.values())      # no kernel runs on the CPU
    want = autograd_of_flash_ref(q, k, v, do, causal)
    _, ref_grads = vjp_of_reference(q, k, v, do, causal)
    for t, a, b in zip((tq, tk, tv), want, ref_grads):
        close(t.grad, a)
        close(t.grad, b)
    with torch.no_grad():
        assert fa.flash_attention(tq, tk, tv, causal).grad_fn is None


def test_flash_attention_bwd_bfloat16_within_2e_2():
    """bf16 inputs: the plain version computes in fp32 and rounds its
    outputs to bf16, within 2e-2 of each output's max of the fp32
    gradient."""
    q, k, v, do = inputs(5, 2, 2, 96, 64)
    t32 = [torch.from_numpy(a) for a in (q, k, v, do)]
    t16 = [t.to(torch.bfloat16) for t in t32]
    o16 = flash_ref(*t16[:3])
    got = fa.flash_attention_bwd(*t16[:3], o16, t16[3])
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = flash_bwd_ref(*[t.float() for t in t16[:3]], o16.float(),
                         t16[3].float())
    for a, b in zip(got, want):
        assert float((a.float() - b).abs().max()) <= 2e-2 * float(
            b.abs().max())


def test_flash_attention_bwd_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in inputs(0, 2, 2, 16, 8))
    o = flash_ref(q, k, v)
    with pytest.raises(ValueError, match="shaped and typed"):
        fa.flash_attention_bwd(q, k, v, o[:, :8], do)
    with pytest.raises(ValueError, match="shaped and typed"):
        fa.flash_attention_bwd(q, k, v, o.double(), do)
    with pytest.raises(ValueError, match="dh <= 128"):
        big = torch.zeros((2, 4, 130))
        fa.flash_attention_bwd(big, big, big, big, big)
