"""Parameters drawn straight into their shards
(``repro_torch.distributed.sharding.init_sharded``), mixtral's windowed
prefill on the flash route, and the configs first served over a mesh from
the sharded draw, on the CPU at SMOKE size.

``init_sharded(model, generator, shardings)`` must give exactly what
``shard_tree(model.init(generator), shardings)`` gives, bit for bit in
every block, for every config and mesh, without any device being handed
more than its own blocks. A mesh takes a list of devices that may repeat
(``["cpu"] * 4``).

mixtral-8x7b's sliding window covers a prompt no longer than it, and
there the window masks nothing the causal mask does not: its three
self-attention callers (``layers.attention_fwd`` in a full forward,
``transformer.decoder_prefill``, ``layers.tp_attention_fwd`` over model
shards) take ``flash_sdpa`` (on the CPU the kernel's plain version) and
keep the masked ``_sdpa`` past the window. Tolerances: the flash route
against the masked one within 1e-6 of the logits' max in float32; against
the reference's prefill at ``tests/test_torch_models.py``'s float32
rtol = atol = 1e-4; served over shards against one device within 1e-5 of
the logits' max (``tests/test_torch_tensor_parallel.py``'s), greedy tokens
equal.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as REF_SMOKE
from repro.models.model import build as ref_build
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models.model import build

MESHES = [(1, 4), (2, 2), (4, 1)]       # (data, model)


def shardings(cfg, model, D, M):
    mesh = MESH.make_host_mesh(M, ["cpu"] * (D * M))
    return mesh, SH.to_named(mesh, SH.param_specs(cfg, mesh,
                                                  model.abstract_params()))


@pytest.mark.parametrize("D,M", MESHES)
@pytest.mark.parametrize("name", sorted(SMOKE))
def test_sharded_draw_equals_shard_tree_of_init(name, D, M):
    """Every leaf: the same spec, shape and dtype, every block on its
    device and bit-equal to ``shard_tree(model.init(g))``'s, and the
    leaf gathered bit-equal to the whole leaf."""
    cfg = SMOKE[name]
    model = build(cfg, "cpu")
    _, sh = shardings(cfg, model, D, M)
    whole = model.init(torch.Generator().manual_seed(7))
    want = SH.shard_tree(whole, sh)
    got = SH.init_sharded(model, torch.Generator().manual_seed(7), sh)
    w_leaves, g_leaves = SH.tree_leaves(want), SH.tree_leaves(got)
    assert len(g_leaves) == len(w_leaves) == len(SH.tree_leaves(whole))
    for a, b, t in zip(g_leaves, w_leaves, SH.tree_leaves(whole)):
        assert isinstance(a, SH.ShardedTensor)
        assert (a.sharding.spec, a.shape, a.dtype) == (
            b.sharding.spec, b.shape, b.dtype)
        for pos in np.ndindex(b.blocks.shape):
            assert a.blocks[pos].device == b.blocks[pos].device
            assert a.blocks[pos].is_contiguous()
            assert torch.equal(a.blocks[pos], b.blocks[pos])
        assert torch.equal(a.gather(), t)


def _ranges(tree, pos):
    """(start, end) of the storage of each block at ``pos``."""
    out = []
    for t in SH.tree_leaves(tree):
        b = t.blocks[pos]
        out.append((b.data_ptr(), b.data_ptr() + b.numel()
                    * b.element_size()))
    return out


@pytest.mark.parametrize("name", ["qwen1.5-110b", "mixtral-8x7b",
                                  "zamba2-7b"])
def test_each_device_is_handed_only_its_blocks(name):
    """On mesh (1, 4), every byte the draw copies (a recording
    ``copy_``) lands in a block (but for zamba2's groups, each drawn
    whole, a layer at a time, before its blocks are written), each device
    is handed exactly the bytes of its blocks, once, which are less than
    the model's, and no one copy carries more than one layer (one group)
    of a stacked leaf or one leaf outside a stack."""
    cfg = SMOKE[name]
    model = build(cfg, "cpu")
    mesh, sh = shardings(cfg, model, 1, 4)
    shapes = model.abstract_params()
    copies = []
    inner = torch.Tensor.copy_

    def copy_(dst, src, *a, **kw):
        # dst is kept, so that no later block reuses a freed one's memory
        copies.append((dst, dst.numel() * dst.element_size(),
                       src.numel() * src.element_size()))
        return inner(dst, src, *a, **kw)

    with mock.patch.object(torch.Tensor, "copy_", copy_):
        got = SH.init_sharded(model, torch.Generator().manual_seed(7), sh)
    positions = list(np.ndindex(mesh.devices.shape))
    ranges = {pos: _ranges(got, pos) for pos in positions}
    handed = dict.fromkeys(positions, 0)
    outside = 0
    for dst, n_dst, n_src in copies:
        assert n_dst == n_src
        ptr = dst.data_ptr()
        at = [pos for pos in positions
              if any(lo <= ptr and ptr + n_dst <= hi
                     for lo, hi in ranges[pos])]
        assert len(at) <= 1
        if at:
            handed[at[0]] += n_dst
        else:
            outside += 1
    assert bool(outside) == (name == "zamba2-7b")
    model_bytes = sum(t.numel() * t.element_size()
                      for t in SH.tree_leaves(shapes))
    for pos in positions:
        mine = sum(hi - lo for lo, hi in ranges[pos])
        assert handed[pos] == mine < model_bytes
    one = max(t.numel() // (t.shape[0] if path[0] in STACKS else 1)
              * t.element_size() for path, t in _with_paths(shapes))
    assert max(n for _, n, _ in copies) <= one


STACKS = ("layers", "super", "tail", "enc_layers", "dec_layers")


def _with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_paths(v, path + (k,))
    else:
        yield path, tree


# ---------------------------------------------- mixtral's window route ----
MIX = "mixtral-8x7b"
B, S_IN, S_PAST = 2, 16, 80          # SMOKE's window is 64


@pytest.fixture(scope="module")
def mixtral():
    """mixtral SMOKE in float32: both packages on the reference's params,
    two prompts (inside and past the window), and the reference's
    prefill logits of the one inside, run once."""
    rcfg = REF_SMOKE[MIX].scaled(dtype="float32")
    cfg = SMOKE[MIX].scaled(dtype="float32")
    assert S_IN <= cfg.swa_window < S_PAST
    ref = ref_build(rcfg)
    np_params = jax.tree.map(np.asarray, ref.init(jax.random.key(4)))
    rng = np.random.default_rng(9)
    toks = {S: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for S in (S_IN, S_PAST)}
    rlogits, _ = jax.jit(ref.prefill)(
        jax.tree.map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(toks[S_IN])}, ref.make_cache(B, S_IN + 4))
    return {"cfg": cfg, "params": params_from_jax(np_params, device="cpu"),
            "tokens": {S: torch.from_numpy(v) for S, v in toks.items()},
            "ref": np.asarray(rlogits, np.float32)}


def _spied():
    """A patch of ``L.flash_sdpa`` recording its calls."""
    calls, inner = [], L.flash_sdpa

    def spy(q, k, v, causal=True):
        calls.append((tuple(q.shape), causal))
        return inner(q, k, v, causal)

    return calls, mock.patch.object(L, "flash_sdpa", spy)


def _masked(cfg):
    """``L.flash_sdpa`` replaced by the masked ``_sdpa`` under the
    window: the route the three callers took before."""
    def masked(q, k, v, causal=True):
        S = q.shape[1]
        return L._sdpa(q, k, v, L.causal_mask(S, S, cfg.swa_window), cfg)
    return mock.patch.object(L, "flash_sdpa", masked)


def _callers(m, S):
    """Last-position logits of the three callers on the prompt of S
    tokens: a full forward (``attention_fwd``), a prefill
    (``decoder_prefill``) and a prefill over mesh (1, 2)
    (``tp_attention_fwd``)."""
    cfg, params = m["cfg"], m["params"]
    tokens = m["tokens"][S]
    model = build(cfg, "cpu")
    with torch.no_grad():
        x, pos, _, _ = model._embed_inputs(params, {"tokens": tokens})
        h, _ = model._trunk(params, x, pos)
        full = L.unembed(params["embed"], cfg, h[:, -1:]).float()
    pre, _ = model.prefill(params, {"tokens": tokens},
                           model.make_cache(B, S + 4))
    mesh = MESH.make_host_mesh(2, ["cpu"] * 2)
    _, tp_prefill, _ = steps.make_serve_steps(cfg, mesh)
    P = SH.shard_tree(params, SH.to_named(mesh, SH.param_specs(
        cfg, mesh, params)))
    tp, _ = tp_prefill(P, {"tokens": tokens}, steps.shard_cache(
        cfg, mesh, model.make_cache(B, S + 4)))
    return {"attention_fwd": full, "decoder_prefill": pre,
            "tp_attention_fwd": tp}


def test_mixtral_inside_its_window_takes_the_flash_route(mixtral):
    """At S <= window each caller calls ``flash_sdpa`` once a layer (a
    layer a shard over the mesh), causal, and its logits equal the masked
    ``_sdpa`` route's within 1e-6 of their max and the reference's
    prefill at rtol = atol = 1e-4."""
    cfg = mixtral["cfg"]
    calls, spy = _spied()
    with spy:
        got = _callers(mixtral, S_IN)
    q = (B, S_IN, cfg.n_heads, cfg.d_head)
    q_shard = (B, S_IN, cfg.n_heads // 2, cfg.d_head)
    assert calls == [(q, True)] * (2 * cfg.n_layers) \
        + [(q_shard, True)] * (2 * cfg.n_layers)
    with _masked(cfg):
        want = _callers(mixtral, S_IN)
    for k, v in got.items():
        err = float((v - want[k]).abs().max())
        assert err <= 1e-6 * float(want[k].abs().max()), (k, err)
        np.testing.assert_allclose(v.numpy(), mixtral["ref"], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_mixtral_past_its_window_keeps_the_masked_route(mixtral):
    """At S > window no caller calls ``flash_sdpa``: each runs the masked
    ``_sdpa`` (with the window's mask), and the three agree within 1e-5
    of their max."""
    cfg = mixtral["cfg"]
    calls, spy = _spied()
    masks, inner = [], L._sdpa

    def sdpa(q, k, v, mask, c):
        masks.append(mask is not None and not bool(mask.all()))
        return inner(q, k, v, mask, c)

    with spy, mock.patch.object(L, "_sdpa", sdpa):
        got = _callers(mixtral, S_PAST)
    assert calls == []
    assert len(masks) == 4 * cfg.n_layers and all(masks)
    scale = float(got["decoder_prefill"].abs().max())
    for k in ("attention_fwd", "tp_attention_fwd"):
        assert float((got[k] - got["decoder_prefill"]).abs().max()) \
            <= 1e-5 * scale, k


# ------------------------------------ serving from the sharded draw -----
SERVE_S, SERVE_DECODE = 12, 4


@pytest.mark.parametrize("name", ["starcoder2-3b", "qwen3-1.7b",
                                  "qwen1.5-110b"])
def test_serve_over_shards_from_the_sharded_draw_equals_one_device(name):
    """``make_serve_steps(cfg, mesh)`` on mesh (1, 4) with params from
    ``init_sharded`` against ``make_serve_steps(cfg)`` on one device with
    ``model.init`` from the same seed, in float32: the prefill's logits
    within 1e-5 of their max, SERVE_DECODE greedy tokens equal."""
    cfg = SMOKE[name].scaled(dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, SERVE_S)).astype(np.int32))
    ctx = SERVE_S + SERVE_DECODE + 2

    def serve(prefill, decode, params, cache):
        logits, cache = prefill(params, {"tokens": tokens}, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(SERVE_DECODE):
            tok, cache = decode(params, tok, cache, SERVE_S + i)
            toks.append(tok)
        return logits, torch.cat(toks, 1)

    m1, p1, d1 = steps.make_serve_steps(cfg, "cpu")
    want, wtoks = serve(p1, d1, m1.init(torch.Generator().manual_seed(5)),
                        m1.make_cache(2, ctx))
    mesh = MESH.make_host_mesh(4, ["cpu"] * 4)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    P = SH.init_sharded(model, torch.Generator().manual_seed(5), SH.to_named(
        mesh, SH.param_specs(cfg, mesh, model.abstract_params())))
    assert any(tuple(t.sharding.spec).count("model")
               for t in SH.tree_leaves(P))
    logits, toks = serve(prefill, decode, P, steps.shard_cache(
        cfg, mesh, model.make_cache(2, ctx)))
    assert logits.shape == want.shape == (2, 1, cfg.vocab)
    assert float((logits - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert torch.equal(toks, wtoks)
