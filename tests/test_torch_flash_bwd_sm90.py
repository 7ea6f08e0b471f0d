"""The tensor-core gradient of the port's flash attention on the CPU: the
forward's log-sum-exp (``flash_ref(..., return_lse=True)``), the plain
version ``flash_bwd_ref(..., lse=)`` of ``flash_attention_bwd_sm90``
against ``jax.vjp`` of the reference's oracle
``repro.kernels.ref.flash_ref``, and the routing of ``FlashAttention``'s
backward between ``flash_attention_bwd_sm90`` (a saved lse; bf16 at dh
64 or a multiple of 8 from 72 to 128) and ``flash_attention_bwd``.

Inputs and the incoming gradient are numpy normals from a seed, handed to
both packages; the reference's oracle gets K/V repeated per group
(``jnp.repeat``), whose vjp sums the G gradients of each key/value row-set.
Tolerance: float32, 1e-4 of each output's max (sums in another order).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_bwd_ref, flash_ref

REL = 1e-4
# (BHkv, G, S, dh): tests/test_torch_flash_bwd.py's shapes, tails 77, 130
SHAPES = [(2, 1, 64, 32), (2, 2, 77, 16), (1, 4, 130, 64), (3, 2, 128, 8)]


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


def vjp_of_reference(q, k, v, do, causal):
    G = q.shape[0] // k.shape[0]

    def f(q, k, v):
        return jax_flash_ref(q, jnp.repeat(k, G, axis=0),
                             jnp.repeat(v, G, axis=0), causal=causal)

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return o, vjp(jnp.asarray(do))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S,dh", SHAPES)
def test_flash_ref_returns_the_masked_logsumexp(BHkv, G, S, dh, causal):
    q, k, v, _ = inputs(S * 7 + G, BHkv, G, S, dh)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_ref(tq, tk, tv, causal, return_lse=True)
    assert torch.equal(o, flash_ref(tq, tk, tv, causal))
    assert lse.shape == (BHkv * G, S) and lse.dtype == torch.float32
    s = torch.einsum("bqd,bkd->bqk", tq,
                     tk.repeat_interleave(G, dim=0)) / np.sqrt(dh)
    if causal:
        s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool).tril(),
                          float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S,dh", SHAPES)
def test_flash_bwd_ref_with_lse_matches_reference(BHkv, G, S, dh, causal):
    """``flash_bwd_ref`` given the forward's lse (no recompute) equals the
    reference's vjp, and its own result without lse."""
    q, k, v, do = inputs(S * 10 + G + 2, BHkv, G, S, dh)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_ref(tq, tk, tv, causal, return_lse=True)
    grads = flash_bwd_ref(tq, tk, tv, o, tdo, causal, lse=lse)
    assert [g.shape for g in grads] == [tq.shape, tk.shape, tv.shape]
    _, ref_grads = vjp_of_reference(q, k, v, do, causal)
    for got, want in zip(grads, ref_grads):
        close(got, want)
    for got, want in zip(grads, flash_bwd_ref(tq, tk, tv, o, tdo, causal)):
        close(got, want)


def _recording():
    """Patches of both backward wrappers that record which one ran."""
    ran = []

    def spy(name, fn):
        def wrapper(*args, **kw):
            ran.append((name, len(args)))
            return fn(*args, **kw)
        return wrapper

    patches = [mock.patch.object(fa, name, spy(name, getattr(fa, name)))
               for name in ("flash_attention_bwd_sm90",
                            "flash_attention_bwd")]
    return ran, patches


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "flash_attention_bwd_sm90"),
    (torch.bfloat16, 128, "flash_attention_bwd_sm90"),
    (torch.bfloat16, 112, "flash_attention_bwd_sm90"),
    (torch.bfloat16, 100, "flash_attention_bwd"),
    (torch.float32, 64, "flash_attention_bwd"),
    (torch.float32, 128, "flash_attention_bwd"),
])
def test_flash_attention_backward_routes_by_the_saved_lse(dtype, dh, want):
    """bf16 with dh in ``SM90_HEAD_DIMS`` (64, 112, 128 here) saves lse in
    the forward and runs ``flash_attention_bwd_sm90`` with it; float32, or
    bf16 with another head dim, runs ``flash_attention_bwd``. On the CPU
    neither counts."""
    q, k, v, do = inputs(dh, 2, 2, 40, dh)
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    ran, patches = _recording()
    fa.reset_counts()
    with patches[0], patches[1]:
        out = fa.flash_attention(tq, tk, tv)
        out.backward(torch.from_numpy(do).to(dtype))
    assert [name for name, _ in ran] == [want]
    # the sm90 wrapper gets q, k, v, o, do and the saved lse
    assert ran[0][1] == (7 if want == "flash_attention_bwd_sm90" else 6)
    assert not any(fa.COUNTS.values())
    for t in (tq, tk, tv):
        assert t.grad.dtype == dtype and t.grad.shape == t.shape
    if dtype == torch.float32:
        _, ref_grads = vjp_of_reference(q, k, v, do, True)
        for t, g in zip((tq, tk, tv), ref_grads):
            close(t.grad, g)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BHkv,G,S", [(2, 1, 77), (1, 4, 130), (2, 2, 64)])
@pytest.mark.parametrize("dh", [64, 96, 112, 128])
def test_flash_attention_sm90_path_gives_the_reference_gradients(
        BHkv, G, S, dh, causal):
    """bf16 through ``FlashAttention``: the forward saves lse and the
    backward runs ``flash_attention_bwd_sm90`` (its plain version on the
    CPU, fp32 inside, dq, dk, dv rounded to bf16), within 2e-2 of each
    output's max of the reference's vjp in float32 on the same bf16
    inputs."""
    q, k, v, do = (np.asarray(torch.from_numpy(a).to(torch.bfloat16)
                              .float())
                   for a in inputs(S + 3 * G + dh, BHkv, G, S, dh))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    ran, patches = _recording()
    with patches[0], patches[1]:
        out = fa.flash_attention(tq, tk, tv, causal)
        out.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert [name for name, _ in ran] == ["flash_attention_bwd_sm90"]
    ref_o, ref_grads = vjp_of_reference(q, k, v, do, causal)
    close(out, ref_o, rel=2e-2)
    for t, want in zip((tq, tk, tv), ref_grads):
        close(t.grad, want, rel=2e-2)


def test_flash_attention_bwd_sm90_bfloat16_within_2e_2():
    """bf16 inputs: the plain version computes in fp32 and rounds dq, dk,
    dv to bf16, within 2e-2 of each output's max of the fp32 gradient."""
    q, k, v, do = inputs(6, 2, 2, 96, 64)
    t16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    o16, lse = fa.flash_attention_sm90(*t16[:3], return_lse=True)
    got = fa.flash_attention_bwd_sm90(*t16[:3], o16, t16[3], lse)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = flash_bwd_ref(*[t.float() for t in t16[:3]], o16.float(),
                         t16[3].float())
    for a, b in zip(got, want):
        close(a, b, rel=2e-2)


def test_flash_attention_bwd_sm90_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in inputs(0, 2, 2, 16, 64))
    o, lse = flash_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="takes bfloat16 with dh"):
        fa.flash_attention_bwd_sm90(q.float(), k.float(), v.float(),
                                    o.float(), do.float(), lse)
    with pytest.raises(ValueError, match="takes bfloat16 with dh"):
        x = torch.zeros((4, 16, 32), dtype=torch.bfloat16)
        kv = torch.zeros((2, 16, 32), dtype=torch.bfloat16)
        fa.flash_attention_bwd_sm90(x, kv, kv, x, x, lse)
    with pytest.raises(ValueError, match=r"lse \[BH, S\]"):
        fa.flash_attention_bwd_sm90(q, k, v, o, do, lse[:, :8])
    with pytest.raises(ValueError, match=r"lse \[BH, S\]"):
        fa.flash_attention_bwd_sm90(q, k, v, o, do, lse.double())
    with pytest.raises(ValueError, match="shaped and typed"):
        fa.flash_attention_bwd_sm90(q, k, v, o[:, :8], do, lse)


@pytest.mark.parametrize("entry,kind", [
    ("flash_attention_bwd_sm90_dkdv_kernel<128>", "flash_attention_bwd_sm90"),
    ("flash_attention_bwd_sm90_delta_kernel<64>", "flash_attention_bwd_sm90"),
    ("flash_attention_bwd_dq_kernel<float, 2>", "flash_attention_bwd"),
    ("flash_attention_sm90_kernel<128>", "flash_attention_fwd"),
])
def test_profile_train_sorts_the_backward_kernels_apart(entry, kind):
    from repro_torch.launch.profile_train import kind_of
    assert kind_of(f"void (anonymous namespace)::{entry}(int)") == kind
