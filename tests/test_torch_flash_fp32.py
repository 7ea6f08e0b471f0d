"""The lse route of the port's float32 flash kernels on the CPU:
``flash_attention_simt(..., return_lse=True)`` (its plain version,
``flash_ref(..., return_lse=True)``), ``flash_attention_bwd(..., lse=)``
(``flash_bwd_ref(..., lse=)``), and ``FlashAttention`` saving the
forward's lse and handing it to ``flash_attention_bwd``, held against
``jax.vjp`` of the reference's oracle ``repro.kernels.ref.flash_ref``.

Inputs and the incoming gradient are numpy normals from a seed, handed to
both packages; the reference's oracle gets K/V repeated per group
(``jnp.repeat``, in ``vjp_of_reference``), whose vjp sums the G gradients
of each key/value row-set. Tolerance: float32 within 1e-5 of each output's
max (the same fp32 math, sums in another order); bf16 within 2e-2 (dq, dk,
dv rounded to bf16).
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
from test_torch_flash_bwd import vjp_of_reference

REL = 1e-5
# (BHkv, G, S, dh): a 16-row query tile and less, tails off the kernels'
# 64-row blocks (77, 130), dh off the 8-wide k-step (20)
SHAPES = [(2, 1, 16, 32), (2, 2, 77, 16), (1, 4, 130, 64), (3, 2, 64, 20)]


def inputs(seed, BHkv, G, S, dh):
    rng = np.random.default_rng(seed)
    shapes = ((BHkv * G, S, dh), (BHkv, S, dh), (BHkv, S, dh),
              (BHkv * G, S, dh))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def close(out, ref, rel=REL):
    out = out.detach().float().numpy() if torch.is_tensor(out) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S,dh", SHAPES)
def test_simt_returns_flash_refs_lse(BHkv, G, S, dh, causal):
    """On the CPU ``flash_attention_simt(return_lse=True)`` is
    ``flash_ref(return_lse=True)``: the same output as without lse, and
    lse ``[BH, S]`` fp32 equal to ``flash_ref``'s; no launch is counted."""
    q, k, v, _ = inputs(S * 3 + G, BHkv, G, S, dh)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    fa.reset_counts()
    o, lse = fa.flash_attention_simt(tq, tk, tv, causal, return_lse=True)
    ref_o, ref_lse = flash_ref(tq, tk, tv, causal, return_lse=True)
    assert lse.shape == (BHkv * G, S) and lse.dtype == torch.float32
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert torch.equal(o, fa.flash_attention_simt(tq, tk, tv, causal))
    assert not any(fa.COUNTS.values())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S,dh", SHAPES)
def test_bwd_with_lse_equals_flash_bwd_ref_and_reference(BHkv, G, S, dh,
                                                         causal):
    """``flash_attention_bwd(lse=)`` equals ``flash_bwd_ref(lse=)`` bit for
    bit on the CPU, and the reference's vjp within 1e-5."""
    q, k, v, do = inputs(S * 5 + G + 1, BHkv, G, S, dh)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_simt(tq, tk, tv, causal, return_lse=True)
    got = fa.flash_attention_bwd(tq, tk, tv, o, tdo, causal, lse=lse)
    want = flash_bwd_ref(tq, tk, tv, o, tdo, causal, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, ref_grads = vjp_of_reference(q, k, v, do, causal)
    for a, b in zip(got, ref_grads):
        close(a, b)


def test_bwd_checks_the_lse_it_is_given():
    q, k, v, do = (torch.from_numpy(a) for a in inputs(0, 2, 2, 16, 8))
    o, lse = flash_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match=r"lse \[BH, S\]"):
        fa.flash_attention_bwd(q, k, v, o, do, lse=lse[:, :8])
    with pytest.raises(ValueError, match=r"lse \[BH, S\]"):
        fa.flash_attention_bwd(q, k, v, o, do, lse=lse.double())


def _spied_bwd():
    """A patch of ``flash_attention_bwd`` that records each call's
    positional count and its ``lse``."""
    calls, real = [], fa.flash_attention_bwd

    def spy(*args, **kw):
        calls.append((len(args), kw.get("lse")))
        return real(*args, **kw)

    return calls, mock.patch.object(fa, "flash_attention_bwd", spy)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S,dh", SHAPES)
def test_float32_autograd_hands_lse_to_the_backward(BHkv, G, S, dh, causal):
    """float32 through ``FlashAttention``: the forward saves
    ``flash_ref``'s lse and the backward runs ``flash_attention_bwd`` once
    with it; the gradients agree with ``jax.vjp`` of the reference's
    oracle within 1e-5 of each one's max."""
    q, k, v, do = inputs(S * 11 + G + dh, BHkv, G, S, dh)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    calls, patch = _spied_bwd()
    with patch:
        out = fa.flash_attention(tq, tk, tv, causal)
        out.backward(torch.from_numpy(do))
    assert len(calls) == 1 and calls[0][0] == 6
    _, want_lse = flash_ref(tq.detach(), tk.detach(), tv.detach(), causal,
                            return_lse=True)
    assert torch.equal(calls[0][1], want_lse)
    ref_o, ref_grads = vjp_of_reference(q, k, v, do, causal)
    close(out, ref_o)
    for t, want in zip((tq, tk, tv), ref_grads):
        close(t.grad, want)


@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_at_dh_32_hands_lse_to_the_backward(causal):
    """bf16 at dh 32 (a head dim ``flash_attention_sm90`` does not take)
    routes to ``flash_attention_simt`` and ``flash_attention_bwd`` with
    the saved lse; the gradients within 2e-2 of each one's max of the
    reference's vjp in float32 on the same bf16 inputs."""
    q, k, v, do = (np.asarray(torch.from_numpy(a).to(torch.bfloat16)
                              .float())
                   for a in inputs(32, 2, 2, 70, 32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    assert fa.route(torch.bfloat16, 32) == "flash_attention_simt"
    calls, patch = _spied_bwd()
    with patch:
        out = fa.flash_attention(tq, tk, tv, causal)
        out.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert len(calls) == 1 and calls[0][1] is not None
    assert calls[0][1].dtype == torch.float32
    _, ref_grads = vjp_of_reference(q, k, v, do, causal)
    for t, want in zip((tq, tk, tv), ref_grads):
        assert t.grad.dtype == torch.bfloat16
        close(t.grad, want, rel=2e-2)
